"""Put the checkout's root on ``sys.path``, so ``benchmark`` and the port
import as they do under ``benchmark/run.py``."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
