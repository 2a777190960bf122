import sys

from fea_large_tpu_torch.cli import main

sys.exit(main())
