import sys

from repro_torch.analysis.cli import main

# guarded, unlike the reference's: importing the module (as the import
# tests do for every module of the port) must not run the linter and exit
if __name__ == "__main__":
    sys.exit(main())
