from . import (cuda_stencil, dispatch, galerkin, gauge_stencil,  # noqa: F401
               nearnull, norms, smoothers, stencil, transfer)
