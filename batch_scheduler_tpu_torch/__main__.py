import sys

from .cmd.main import main

if __name__ == "__main__":
    sys.exit(main())
