"""
`pcr` — drop-in compatibility alias for `pcr_tpu`.

Lets code written against the reference library's Python bindings
(reference: python/pcr/__init__.py) run unchanged: `import pcr` resolves to
the JAX framework.
"""
from pcr_tpu import *          # noqa: F401,F403
from pcr_tpu import __all__, __version__  # noqa: F401

# Reference-layout submodule aliases (python/pcr/ in the reference):
# pcr.test_generators, pcr.visualization, pcr.testing, pcr.rasterio_bridge
import sys as _sys

from pcr_tpu.testing import generators as test_generators  # noqa: E402
from pcr_tpu.utils import visualization  # noqa: E402
from pcr_tpu import testing  # noqa: E402
from pcr_tpu.io import rasterio_bridge  # noqa: E402

_sys.modules[__name__ + ".test_generators"] = test_generators
_sys.modules[__name__ + ".visualization"] = visualization
_sys.modules[__name__ + ".testing"] = testing
_sys.modules[__name__ + ".rasterio_bridge"] = rasterio_bridge
