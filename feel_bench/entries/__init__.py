"""One module a program path the benchmark drives; a traffic file names
its entry."""
