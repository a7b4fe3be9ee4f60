"""I/O surface: reference-compatible results files, near-null checkpoints
and structured JSONL metrics (counterpart of tpu_multigrid/utils/io.py;
the files are byte-identical to the JAX package's).

The reference's text files are its de-facto API to the analysis notebooks
(SURVEY.md §5.5, Appendix B).

Formats (reference file:line):
- results_phi.txt            iter, then L^2*ndof x "re+i im,"   (level.h:288-300)
- results_res_lvl-{l}.txt    same layout for the residual field (level.h:268-286)
- results_NTL_weights.txt    iter, 4 x "re+i im,"               (modules_indiv.h:137-143)
- results_gen_scaling.txt    TSV append: L num_iters m block_x block_y
                             n_dof_scale nlevels iters           (modules_main.h:472)
- Near-null_L{L}_blk{b}_ndof{s}.txt: "%25.20e+i%25.20e" per line; levels
  0..nlevels-1; per level j=0..L^2-1 (j = x + y*L), d1 (coarse), d2 (fine)
                                                    (modules_main.h:39-79)
"""
from __future__ import annotations

import json
import os
from typing import List

import numpy as np
import torch

from ..ops.stencil import residual
from ..ops.transfer import restrict


def host(x) -> np.ndarray:
    """A tensor (on any device) or array as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _fmt_c(z) -> str:
    # byte-compatible with the reference's %25.20e+i%25.20e
    # (modules_main.h:65-79, level.h:288-300): width 25, precision 20
    return f"{z.real:25.20e}+i{z.imag:25.20e}"


def _field_to_ref_order(v: np.ndarray) -> np.ndarray:
    """[n, L, L] -> flat reference order: outer loop x, inner y, dof
    innermost (level.h:282-284, 295-298)."""
    return np.transpose(v, (1, 2, 0)).reshape(-1)


def _field_line(it: int, v: np.ndarray) -> str:
    """'it,' then every value of field v as '%25.20e+i%25.20e,' in
    reference order: _fmt_c's bytes, formatted in one %-operation."""
    z = _field_to_ref_order(v)
    inter = np.empty(2 * z.size, dtype=np.float64)
    inter[0::2], inter[1::2] = z.real, z.imag
    return f"{it}," + ("%25.20e+i%25.20e," * z.size) % tuple(
        inter.tolist()) + "\n"


class ResultsWriter:
    """Reference-compatible per-iteration result files + jsonl metrics."""

    def __init__(self, cfg, out_dir: str = ".", jsonl: bool = True):
        self.cfg = cfg
        self.dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.f_phi = open(os.path.join(out_dir, "results_phi.txt"), "w")
        self.f_w = open(os.path.join(out_dir, "results_NTL_weights.txt"), "w")
        self.f_res = [
            open(os.path.join(out_dir, f"results_res_lvl-{l}.txt"), "w")
            for l in range(cfg.nlevels + 1)]
        self.f_jsonl = (open(os.path.join(out_dir, "metrics.jsonl"), "w")
                        if jsonl else None)

    def record(self, it: int, hier, phis, b, weights: np.ndarray):
        """Append cycle `it`: phi, the per-level residual fields and the
        NTL weights (and a metrics.jsonl row)."""
        cfg = self.cfg
        self.f_phi.write(_field_line(it, host(phis[0])))

        # Per-level residual fields: level 0 is r = b - D phi; deeper
        # levels log the successively restricted residual (the coarse rhs
        # the next cycle will see).
        res = residual(hier.levels[0].D, phis[0], b)
        for l, f in enumerate(self.f_res):
            if l > 0:
                res = restrict(hier.levels[l - 1].phi_null, res, cfg.quad,
                               cfg.block_x, cfg.block_y)
            field = host(res)
            if l == 0:
                res0 = field
            f.write(_field_line(it, field))

        weights = host(weights)
        self.f_w.write(f"{it},")
        for z in weights:
            self.f_w.write(f"{z.real:.4e}+i{z.imag:.4e},")
        self.f_w.write("\n")

        if self.f_jsonl is not None:
            rel = float(np.linalg.norm(res0) / np.linalg.norm(host(b)))
            self.f_jsonl.write(json.dumps(
                {"iter": it, "rel_residual": rel,
                 "ntl_weights_re": [float(w.real) for w in weights],
                 "ntl_weights_im": [float(w.imag) for w in weights]}) + "\n")

    def write_scaling_summary(self, conv_iters: int):
        cfg = self.cfg
        with open(os.path.join(self.dir, "results_gen_scaling.txt"),
                  "a") as f:
            f.write(f"{cfg.L}\t{cfg.num_iters}\t{cfg.m:f}\t{cfg.block_x}\t"
                    f"{cfg.block_y}\t{cfg.n_dof_scale}\t{cfg.nlevels}\t"
                    f"{conv_iters}\n")

    def close(self):
        self.f_phi.close()
        self.f_w.close()
        for f in self.f_res:
            f.close()
        if self.f_jsonl is not None:
            self.f_jsonl.close()


# --- near-null checkpoints -------------------------------------------------

def near_null_filename(cfg) -> str:
    return f"Near-null_L{cfg.L}_blk{cfg.block_x}_ndof{cfg.n_dof_scale}.txt"


def save_near_null_text(path: str, phi_nulls: List):
    """Write the reference checkpoint format (modules_main.h:65-79), by
    the native writer when it builds."""
    from . import native
    # order: j = x + y*L (x fastest), d1, d2
    vals = np.concatenate([np.transpose(host(pn), (3, 2, 0, 1)).reshape(-1)
                           for pn in phi_nulls])
    if native.available():
        native.write_complex_text(path, vals)
        return
    with open(path, "w") as f:
        for z in vals:
            f.write(_fmt_c(z) + "\n")


def _parse_complex_lines(path: str, n_expected: int) -> np.ndarray:
    from . import native
    if native.available():
        return native.read_complex_text(path, n_expected)
    vals = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            re, _, im = line.partition("+i")
            vals.append(complex(float(re), float(im)))
    return np.asarray(vals)


def load_near_null_text(path: str, cfg) -> List[np.ndarray]:
    """Read the reference checkpoint format (modules_main.h:39-63)."""
    total = sum(cfg.sizes[l] ** 2 * cfg.n_dof[l + 1] * cfg.n_dof[l]
                for l in range(cfg.nlevels))
    vals = _parse_complex_lines(path, total)
    out = []
    pos = 0
    for lvl in range(cfg.nlevels):
        L = cfg.sizes[lvl]
        nf, nc = cfg.n_dof[lvl], cfg.n_dof[lvl + 1]
        n = L * L * nc * nf
        # j = x + y*L with x fastest -> linear order is [y][x][d1][d2]
        block = np.asarray(vals[pos:pos + n]).reshape(L, L, nc, nf)
        out.append(np.transpose(block, (2, 3, 1, 0)))  # [nc, nf, x, y]
        pos += n
    if pos != len(vals):
        raise ValueError(f"file has {len(vals)} values, expected {pos}")
    return out


def save_near_null_npz(path: str, phi_nulls: List):
    np.savez_compressed(path, **{f"level_{i}": host(p)
                                 for i, p in enumerate(phi_nulls)})


def load_near_null_npz(path: str) -> List[np.ndarray]:
    with np.load(path) as z:
        return [z[f"level_{i}"] for i in range(len(z.files))]
