"""python -m stellar_core_tpu_torch <subcommand> — the node CLI
(ref src/main/main.cpp -> CommandLine)."""
import sys

from .main.command_line import main

sys.exit(main())
