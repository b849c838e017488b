import sys

from .harness import main

sys.exit(main(sys.argv[1:]))
