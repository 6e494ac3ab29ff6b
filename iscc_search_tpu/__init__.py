"""
iscc-search-tpu — accelerator similarity-search framework for ISCC codes.

A ground-up JAX/XLA redesign of the capabilities of iscc/iscc-search:
device-resident bit-packed ISCC-UNIT codes, an exhaustive ±1-matmul NPHD
scan with exact block-max top-k (recall 1.0), per-unit-type partitioning,
granular SIMPRINT chunk matching, multi-device sharding over a
``jax.sharding.Mesh`` with collective top-k merge, plus the full product
surface: protocol backends, REST server, CLI, remote client, and the IDP
transparency-log aggregator.
"""

import os as _os

__version__ = "0.5.0"

APP_NAME = "iscc-search-tpu"


class _Dirs:
    """Default data location under the XDG base directory (mirrors the
    reference's ``iscc_search.dirs``); read at access time, so a changed
    ``XDG_DATA_HOME`` or ``HOME`` applies to the next lookup."""

    @property
    def user_data_dir(self):
        # type: () -> str
        base = _os.environ.get("XDG_DATA_HOME") or _os.path.expanduser("~/.local/share")
        return _os.path.join(base, APP_NAME)


#: Default data directory (see :class:`_Dirs`)
dirs = _Dirs()
