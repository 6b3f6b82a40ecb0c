"""Make the repo root importable when benchmarks run as plain files.

`python benchmarks/foo.py` puts `benchmarks/` (not the repo root) at
`sys.path[0]`, and nothing pip-installs the package — so the
`local_search_quantization` (and `bench`) imports die from any
fresh shell. Importing this module inserts the repo root ahead of the
script directory; under `python -m benchmarks.foo` the repo root is
already on the path and callers import this shim inside try/except.

Deliberately byte-similar to scripts/_bootstrap.py and
demos/_bootstrap.py: the three copies cannot share a module (importing
the shared copy would itself need the path fix they exist to provide),
so any fix here must be applied to all three.
"""

from __future__ import annotations

import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)
