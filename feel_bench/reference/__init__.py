"""Plain references of what each entry's window computes; they import
nothing of the program."""
