"""``python -m znicz_tpu_torch``: the launcher's entry point (port of
``znicz_tpu/__main__.py``)."""

import sys

from znicz_tpu_torch.launcher import main

if __name__ == "__main__":
    sys.exit(main())
