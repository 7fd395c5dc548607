import sys

from .gen import main

sys.exit(main())
