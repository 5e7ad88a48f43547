import sys

from macroc_tpu_torch.cli import main

sys.exit(main())
