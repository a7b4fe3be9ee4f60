from . import (cuda_stencil, galerkin, gauge_stencil, nearnull, norms,  # noqa: F401
               smoothers, stencil, transfer)
