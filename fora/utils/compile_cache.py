"""One persistent XLA compile cache for every entry point.

``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself and this
module sets nothing.  Otherwise the cache lives at one fixed path beside the
package (``<checkout>/.jax_cache``, gitignored), resolved from this file and
not from the working directory or a dataset prefix: the directory is part of
every entry's key, so a cache that moves between runs never hits.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> Optional[Path]:
    """Point JAX's persistent cache at DEFAULT_DIR unless the environment
    already chose a directory.  Returns the directory set, or None."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    import jax
    DEFAULT_DIR.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return DEFAULT_DIR
