"""Make the repo root importable when scripts run as plain files.

`python scripts/foo.py` puts `scripts/` (not the repo root) at
`sys.path[0]`, and nothing pip-installs the package — so the
`local_search_quantization` import dies from any fresh shell.
The reference's demos are runnable as plain scripts from anywhere
(/root/reference/demos/demo_lsq.jl:2-7 composes via include()); this
module is the Python equivalent: importing it inserts the repo root
ahead of the script directory. Works from any cwd because it locates
itself, not the process.
Deliberately byte-similar to the sibling _bootstrap.py copies in
scripts/, demos/, and benchmarks/: the copies cannot share a module
(importing the shared copy would itself need the path fix they exist
to provide), so any fix here must be applied to all of them.
"""

from __future__ import annotations

import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)
