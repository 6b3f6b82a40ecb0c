"""Which implementation runs on which platform: the one route table.

Every platform-dependent choice of the package reads it — the ICM
conditioning of an "auto" encode (ops/icm.py), whether an "auto" search may
leave the device for the native host scanner (ops/adc.py), and whether an
Index keeps its codes uploaded between searches (index.py). Single-device
code keys the table on `jax.devices()[0].platform`; mesh code keys it on
`parallel.mesh.mesh_platform(mesh)`, the platform the program will run on.

Also home to `enable_compile_cache`, the persistent-compile-cache placement
every entry-point script calls before its first compile.
"""

from __future__ import annotations

import os
from typing import NamedTuple


class Route(NamedTuple):
    # ICM conditioning for condition_mode="auto" (ops/icm.py).
    condition_mode: str
    # topk_method="auto" may answer from the native host scanner when the
    # library is built and the codes are bytes (ops/adc.py).
    host_scan: bool
    # Index.search keeps the transposed codes on the device between calls.
    device_code_cache: bool


ROUTES = {
    # H100 measurements (ILS n=131072, m=7, h=256, d=128, icmiter=4,
    # npert=4): the bf16 one-hot matmul conditioning runs 7.5M vector-rounds
    # per second against 5.1M for the row gathers, at equal mean cost
    # (accept-if-better uses exact f32 costs in both). Search stays on the
    # card with its codes cached there.
    "gpu": Route(condition_mode="matmul", host_scan=False,
                 device_code_cache=True),
    # Host serving: the native scanner over host RAM when it is built, so
    # nothing is kept on the (host) device between searches.
    "cpu": Route(condition_mode="gather", host_scan=True,
                 device_code_cache=False),
}


def platform_route(platform: str | None = None) -> Route:
    """The route for `platform` (default: the platform of jax.devices()[0]).

    Raises ValueError for a platform the table does not list — no silent
    default to another platform's route."""
    if platform is None:
        import jax

        platform = jax.devices()[0].platform
    try:
        return ROUTES[platform]
    except KeyError:
        raise ValueError(
            f"no route for platform {platform!r}; this package runs on "
            f"{sorted(ROUTES)}") from None


_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at a fixed directory.

    `JAX_COMPILATION_CACHE_DIR` wins when set; otherwise the cache lives at
    `<repo>/.cache/jax` (ignored by git), the same path from any working
    directory, so a later process finds what an earlier one compiled.
    Returns the directory. Entry points call this before their first
    compile; importing the package does not."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _REPO_ROOT, ".cache", "jax")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
