"""Where the port finds the repository's bundled configs.

Counterpart of ``blurr_tpu/paths.py``. Both packages serve the same YAML
configs, which live in the JAX package's tree (``blurr_tpu/config/eval``).
The port reads them as data, by path from its own file; it imports nothing
of ``blurr_tpu``.
"""

from pathlib import Path

_PACKAGE_DIR = Path(__file__).resolve().parent


def repo_root() -> Path:
    """Root of this repository (one level above the package)."""
    return _PACKAGE_DIR.parent


def config_root() -> Path:
    """The bundled YAML config tree (``blurr_tpu/config``)."""
    return repo_root() / "blurr_tpu" / "config"
