"""`python -m moshpp_torch` entry point."""

import sys

from moshpp_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
