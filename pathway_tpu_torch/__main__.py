"""``python -m pathway_tpu_torch`` → the port's command-line tools."""

import sys

from pathway_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
