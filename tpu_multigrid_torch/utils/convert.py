"""State bridge from the JAX package, in plain Python and numpy: a JAX
`MGConfig` (or a geometric `GeoConfig` / `Geo2Config`) as
`dataclasses.asdict`, and a JAX hierarchy's leaves as numpy arrays (a
batched ensemble hierarchy with its leading batch axis), become the port's
config and `Hierarchy`. Tests use it to run both packages on the same
hierarchy."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..config import MGConfig
from ..solver.hierarchy import Hierarchy, LevelOps, NTLOps


def config_from_dict(d: dict) -> MGConfig:
    """MGConfig from `dataclasses.asdict` of a JAX MGConfig."""
    d = dict(d)
    if d.get("cheby_lmax") is not None:
        d["cheby_lmax"] = tuple(d["cheby_lmax"])
    return MGConfig(**d)


def geo_config_from_dict(d: dict):
    """solver.geometric.Geo2Config (when the dict has gen 2's fields) or
    GeoConfig from `dataclasses.asdict` of the JAX package's."""
    from ..solver.geometric import Geo2Config, GeoConfig
    return (Geo2Config if "t_flag" in d else GeoConfig)(**d)


def _tensor(a, device, dtype):
    return None if a is None else torch.from_numpy(
        np.array(a, order="C")).to(device=device, dtype=dtype)


def hierarchy_from_numpy(levels: Sequence, ntl: Optional[Sequence],
                         gauge: Optional[np.ndarray], device=None,
                         dtype=torch.complex128) -> Hierarchy:
    """levels: one (D, D0inv, phi_null or None) per level; ntl: None or
    (phi_null, D, D0inv) with the copy axis first; gauge: None or U. A
    batched (ensemble) hierarchy's arrays keep their leading batch axis
    (the copy axis is then second), as solver.ensemble's do."""
    lv = tuple(LevelOps(D=_tensor(D, device, dtype),
                        D0inv=_tensor(Dinv, device, dtype),
                        phi_null=_tensor(pn, device, dtype))
               for D, Dinv, pn in levels)
    nt = None
    if ntl is not None:
        pn, D, Dinv = ntl
        nt = NTLOps(phi_null=_tensor(pn, device, dtype),
                    D=_tensor(D, device, dtype),
                    D0inv=_tensor(Dinv, device, dtype))
    return Hierarchy(levels=lv, ntl=nt, gauge=_tensor(gauge, device, dtype))
