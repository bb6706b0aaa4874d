"""Put the repository root on the path, so ``portbench`` and the program
import as they do under ``portbench/run.py``."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
