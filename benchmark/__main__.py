import sys

from benchmark.harness import main

sys.exit(main())
