"""Fault detection and graceful degradation for the crossbar substrates
— counterpart of ``repro/faults/mitigate.py``.

Four composable layers, in the order a controller would run them:

  march_recover     write/read-back self-test that recovers the stuck-cell
                    map without being told where the faults are.
  remap_columns     redundant-column repair: retire the worst faulty
                    logical columns onto the tile's spare columns by
                    rewriting the column map (metadata, no writes).
  compensate_bias   fold each stuck cell's expected pre-activation error
                    (under calibration drive means) into the healthy
                    digital bias registers.
  recalibrate       a short burst of continued on-chip training with the
                    masks active: the healthy cells re-learn around what
                    remains.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.analog.crossbar import f32
from repro_torch.faults.model import effective_masks, fault_state


# ---------------------------------------------------------------------------
# Detection — march-style write/read-back self-test
# ---------------------------------------------------------------------------

def march_recover(backend, params: dict, state: Any, *,
                  probe: Optional[float] = None,
                  tol: Optional[float] = None) -> dict:
    """The stuck-cell map of every crossbar tile, by self-test.

    March element: program the whole tile to ``-probe``, read it back with
    one-hot drives (each output element isolates one cell), then again at
    ``+probe``. A healthy cell tracks the programmed value through the
    WBS/ADC stack to within quantization; a stuck cell returns the same
    conductance both times, so it deviates on at least one read. The
    recovered value of a flagged cell is the mean of its two reads.

    Reads go through ``device_vmm`` with a state that carries only the
    fault masks (the probe pattern, not the programmed pairs, is what the
    substrate quantizes), with no key: deterministic, ideal plane gains,
    no read noise. On the card each read is one ``wbs_matmul`` launch of
    the (n_in, n_in) identity against the tile."""
    fstate = fault_state(state)
    v = probe if probe is not None \
        else 0.5 * backend._fault_value_scale()
    if tol is None:
        tol = 0.25 * v
    v32, tol32 = f32(v), f32(tol)
    probe_state = None if fstate is None else {"_faults": fstate}
    recovered = {}
    with torch.no_grad():
        for name in sorted(params):
            p = params[name]
            if p.ndim < 2:
                continue
            if fstate is not None and name not in fstate:
                continue
            eye = torch.eye(p.shape[0], dtype=p.dtype, device=p.device)
            w_lo = torch.full(p.shape, -v32, dtype=p.dtype, device=p.device)
            w_hi = torch.full(p.shape, v32, dtype=p.dtype, device=p.device)
            r_lo = backend.device_vmm(eye, w_lo, state=probe_state, tag=name)
            r_hi = backend.device_vmm(eye, w_hi, state=probe_state, tag=name)
            bad = (torch.abs(r_lo + v32) > tol32) \
                | (torch.abs(r_hi - v32) > tol32)
            val = torch.where(bad, 0.5 * (r_lo + r_hi),
                              torch.zeros_like(r_lo)).to(torch.float32)
            recovered[name] = {"stuck": bad, "value": val}
    return recovered


# ---------------------------------------------------------------------------
# Mitigation 1 — redundant-column remap
# ---------------------------------------------------------------------------

def remap_columns(fstate: dict) -> dict:
    """Retire the faultiest logical columns onto spare columns.

    Greedy, on the host: columns ranked by stuck-cell count, spares by
    their own (spares can be born faulty); a column moves only onto a
    strictly healthier spare, and each spare is taken at most once, so
    the column map stays injective. Tiles without spares pass through."""
    out = {}
    for name, tile in fstate.items():
        if "colmap" not in tile:
            out[name] = tile
            continue
        stuck = tile["stuck"].cpu().numpy()
        sp = tile["spare_stuck"].cpu().numpy()
        n_out = stuck.shape[1]
        col_bad = stuck.sum(axis=0)
        sp_bad = sp.sum(axis=0)
        spares = list(np.argsort(sp_bad, kind="stable"))
        colmap = np.arange(n_out, dtype=np.int32)
        for j in np.argsort(-col_bad, kind="stable"):
            if not spares or col_bad[j] == 0:
                break
            s = spares[0]
            if sp_bad[s] >= col_bad[j]:
                break
            spares.pop(0)
            colmap[j] = n_out + s
        out[name] = {**tile, "colmap": torch.from_numpy(colmap).to(
            tile["stuck"].device)}
    return out


# ---------------------------------------------------------------------------
# Mitigation 2 — compensation re-programming (healthy bias registers)
# ---------------------------------------------------------------------------

def calibration_drives(backend, params: dict, cfg, x_calib: torch.Tensor,
                       key: Optional[np.ndarray],
                       state: Any = None) -> dict:
    """Mean drive vector a hidden tile sees under a calibration batch:
    the input stream's feature means for ``w_h`` and the faulty
    forward's mean recurrent drive (β·h) for ``u_h``."""
    with torch.no_grad():
        _, h_prev, _ = backend.device_recurrence(params, cfg, x_calib, key,
                                                 state=state)
        d_x = torch.mean(x_calib.reshape(-1, x_calib.shape[-1]), dim=0)
        d_h = cfg.beta * torch.mean(h_prev.reshape(-1, h_prev.shape[-1]),
                                    dim=0)
    return {"w_h": d_x, "u_h": d_h}


def compensate_bias(params: dict, fstate: dict, drives: dict) -> dict:
    """Cancel each stuck cell's expected pre-activation contribution in
    the healthy digital bias registers:

        b_h[j] -= Σ_i d̄_i · (v_ij − w_ij)   over stuck cells (i, j)

    with d̄ the tile's calibration drive mean and v the stuck value
    (first-order mean compensation; :func:`recalibrate` cleans up the
    rest)."""
    delta = torch.zeros_like(params["b_h"])
    for tag, d in drives.items():
        tile = fstate.get(tag)
        if tile is None or tag not in params:
            continue
        stuck, value = effective_masks(tile)
        w = params[tag]
        err = torch.sum(torch.where(stuck,
                                    (value.to(w.dtype) - w) * d[:, None],
                                    torch.zeros_like(w)), dim=0)
        delta = delta + err
    out = dict(params)
    out["b_h"] = params["b_h"] - delta
    return out


# ---------------------------------------------------------------------------
# Mitigation 3 — recalibration (continued on-chip training under faults)
# ---------------------------------------------------------------------------

def recalibrate(cfg, trainer, backend, params: dict, state: Any, task, *,
                steps: int = 8, seed: int = 0):
    """``steps`` more training batches with the fault masks active.
    Writes aimed at stuck cells are rejected by the device layer, so only
    healthy cells move. Batches are ``prng.choice`` draws without
    replacement from ``task``'s training rows, on the reference's key
    chain (``PRNGKey(seed)`` split three ways a step). Returns
    (params, state)."""
    from repro_torch.core.continual import _init_run, _make_raw_steps

    dev = next(iter(params.values())).device
    train_step, _, opt = _make_raw_steps(cfg, trainer, backend)
    _, _, psi, _ = _init_run(cfg, trainer, backend, dev)
    opt_state = opt.init(params) if trainer.algo == "adam" \
        else {"psi": psi}
    k = prng.PRNGKey(seed)
    n = task.x_train.shape[0]
    B = min(trainer.batch_size, n)
    with torch.no_grad():
        for _ in range(steps):
            k, k_step, k_batch = prng.split(k, 3)
            idx = prng.choice(k_batch, n, (B,))
            x = torch.from_numpy(task.x_train[idx]).to(dev)
            y = torch.from_numpy(task.y_train[idx]).to(dev)
            params, opt_state, _, applied, state = train_step(
                params, opt_state, k_step, x, y, state)
            backend.record_endurance(applied)
    return params, state
