"""Comparisons shared by the tests and ``chip_smoke.py``.

Two implementations of the WBS path that sum in different orders (XLA's
dot against the port's kernels, say) can differ in ``pre`` by an ulp.
Where the output ADC (step 1/32 at 8 bits, ±4) or the sign-magnitude
input quantizer rounds, an ulp occasionally lands on the other side of a
rounding tie and moves one code by one level; through the λ-recurrence
that moves the row's later outputs by up to about 1e-2. So these helpers
compare row by row (a row is one batch row across its frames):

* every output before the row's first differing frame matches at
  ``rtol``/``atol`` (2e-5 each, the reference's own kernel-vs-ref
  tolerance);
* at that frame every differing code differs by exactly one level and is
  a tie: the unrounded value (recomputed in float64 from each side's own
  state) lies within :data:`TIE_WINDOW` of a half-integer on both sides,
  or an input code of that row flipped on such a tie in the same frame;
* later frames of a flipped row are not compared, and the flipped rows
  are counted: :meth:`TieReport.check` allows at most 1 % of the rows.

Anything else raises ``AssertionError``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

RTOL = 2e-5
ATOL = 2e-5
TIE_WINDOW = 1e-3
MAX_FLIP_FRAC = 0.01


@dataclasses.dataclass
class TieReport:
    rows: int
    flipped_rows: int = 0
    max_abs_err: float = 0.0       # over the compared outputs
    #: (row, frame, codes that differ) of each flip.
    flips: list = dataclasses.field(default_factory=list)

    def check(self, max_flip_frac: float = MAX_FLIP_FRAC) -> "TieReport":
        if self.flipped_rows > max_flip_frac * self.rows:
            raise AssertionError(
                f"{self.flipped_rows} of {self.rows} rows flipped on a tie, "
                f"more than {max_flip_frac:.0%}: {self.flips}")
        return self

    def as_dict(self) -> dict:
        return {"rows": self.rows, "flipped_rows": self.flipped_rows,
                "max_abs_err": self.max_abs_err}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _tie_distance(x: np.ndarray) -> np.ndarray:
    """Distance of x from the nearest half-integer."""
    return np.abs(x - np.floor(x) - 0.5)


def _input_codes(h: np.ndarray, beta: float, n_bits: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Signed sign-magnitude codes of beta*h, quantized in float32 as the
    kernels do, and each value's distance from a rounding tie."""
    scaled = np.abs(np.float32(beta) * h.astype(np.float32)) \
        * np.float32(2 ** n_bits - 1)
    code = np.minimum(np.rint(scaled), 2 ** n_bits - 1)
    return np.sign(h) * code, _tie_distance(scaled)


def _deq(sign: np.ndarray, code: np.ndarray, gains: np.ndarray
         ) -> np.ndarray:
    """Σ_b gains[b]·plane_b·sign in float64 (planes MSB first)."""
    n_bits = gains.shape[-1]
    code = code.astype(np.int64)
    out = np.zeros(code.shape, np.float64)
    for b in range(n_bits):
        out += gains[..., b, None].astype(np.float64) \
            * ((code >> (n_bits - 1 - b)) & 1)
    return out * sign


def _ideal_gains(n_bits: int) -> np.ndarray:
    return 2.0 ** -np.arange(1, n_bits + 1, dtype=np.float64)


def compare_scan(got: Sequence, want: Sequence, *, drive, u_scaled, b_h,
                 beta: float, n_bits: int, w_scale: float = 1.0,
                 adc_bits: Optional[int] = None, adc_range: float = 4.0,
                 gains=None, rtol: float = RTOL, atol: float = ATOL
                 ) -> TieReport:
    """Compare two (h_all, h_prev, pre) results of the WBS×MiRU scan on
    the same inputs (``u_scaled`` is U already divided by ``w_scale``;
    ``gains`` (T, n_bits) or None for ideal ratios)."""
    g = [_np(a).astype(np.float64) for a in got]
    w = [_np(a).astype(np.float64) for a in want]
    B, T, H = g[0].shape
    drive64, u64 = _np(drive).astype(np.float64), _np(u_scaled).astype(
        np.float64)
    b64 = _np(b_h).astype(np.float64).reshape(H)
    gains64 = _np(gains).astype(np.float64) if gains is not None \
        else np.broadcast_to(_ideal_gains(n_bits), (T, n_bits))
    norm = 2.0 ** n_bits / (2.0 ** n_bits - 1.0)
    step = None if adc_bits is None else 2.0 * adc_range / 2 ** adc_bits

    in_g, in_tie_g = _input_codes(_np(got[1]), beta, n_bits)
    in_w, in_tie_w = _input_codes(_np(want[1]), beta, n_bits)
    close = np.ones((B, T), bool)
    for a, b in zip(g, w):
        close &= np.isclose(a, b, rtol=rtol, atol=atol).all(-1)
    if step is not None:
        out_g, out_w = np.rint(g[2] / step), np.rint(w[2] / step)
        close &= (out_g == out_w).all(-1)

    def unrounded(h_prev_row, b, t):
        codes, _ = _input_codes(h_prev_row, beta, n_bits)
        deq = _deq(np.sign(codes), np.abs(codes), gains64[t])
        return (drive64[b, t] + (deq @ u64) * norm * w_scale + b64) / step

    report = TieReport(rows=B)
    for b in range(B):
        bad = np.flatnonzero(~close[b])
        t0 = bad[0] if bad.size else T
        for a, c in zip(g, w):
            if t0:
                report.max_abs_err = max(report.max_abs_err, float(
                    np.abs(a[b, :t0] - c[b, :t0]).max()))
        if t0 == T:
            continue
        in_diff = in_g[b, t0] != in_w[b, t0]
        input_tie = bool(in_diff.any()) and bool(
            (np.abs(in_g[b, t0] - in_w[b, t0])[in_diff] == 1).all()
            and (in_tie_g[b, t0][in_diff] <= TIE_WINDOW).all()
            and (in_tie_w[b, t0][in_diff] <= TIE_WINDOW).all())
        if step is None:
            ok, n_codes = input_tie, int(in_diff.sum())
        else:
            out_diff = out_g[b, t0] != out_w[b, t0]
            one_level = bool((np.abs(out_g[b, t0] - out_w[b, t0])
                              [out_diff] == 1).all())
            dist_g = _tie_distance(unrounded(_np(got[1])[b, t0], b, t0))
            dist_w = _tie_distance(unrounded(_np(want[1])[b, t0], b, t0))
            adc_tie = bool(out_diff.any()) and bool(
                (dist_g[out_diff] <= TIE_WINDOW).all()
                and (dist_w[out_diff] <= TIE_WINDOW).all())
            ok = one_level and (adc_tie or input_tie)
            n_codes = int(out_diff.sum()) + int(in_diff.sum())
        if not ok:
            frame = {k: (np.round(a[b, t0, :8], 6), np.round(c[b, t0, :8], 6))
                     for k, a, c in zip(("h_all", "h_prev", "pre"), g, w)}
            raise AssertionError(
                f"row {b} diverges at frame {t0} without a one-level "
                f"rounding tie (first 8 columns, got vs want): {frame}")
        report.flipped_rows += 1
        report.flips.append((b, int(t0), n_codes))
    return report


def compare_matmul(got, want, *, sign, code, w, gains,
                   adc_bits: Optional[int] = None, adc_range: float = 4.0,
                   rtol: float = RTOL, atol: float = ATOL) -> TieReport:
    """Compare two (M, N) results of the WBS crossbar product on the same
    inputs. A row is one output row; with the ADC on, a differing code
    must be one level apart with the unrounded product (float64) within
    :data:`TIE_WINDOW` of a half-integer."""
    g, wt = _np(got).astype(np.float64), _np(want).astype(np.float64)
    close = np.isclose(g, wt, rtol=rtol, atol=atol)
    report = TieReport(rows=g.shape[0])
    if adc_bits is None:
        if not close.all():
            raise AssertionError(
                f"{int((~close).sum())} elements outside rtol={rtol}, "
                f"atol={atol}; max |diff| {np.abs(g - wt).max()}")
        report.max_abs_err = float(np.abs(g - wt).max(initial=0.0))
        return report
    step = 2.0 * adc_range / 2 ** adc_bits
    gains64 = _np(gains).astype(np.float64)
    n_bits = gains64.shape[0]
    deq = _deq(_np(sign).astype(np.float64), _np(code), gains64)
    unrounded = deq @ _np(w).astype(np.float64) \
        * (2.0 ** n_bits / (2.0 ** n_bits - 1.0)) / step
    diff = np.rint(g / step) != np.rint(wt / step)
    bad = diff & ~((np.abs(np.rint(g / step) - np.rint(wt / step)) == 1)
                   & (_tie_distance(unrounded) <= TIE_WINDOW))
    if bad.any() or not (close | diff).all():
        raise AssertionError(
            f"{int(bad.sum())} codes differ without a one-level tie and "
            f"{int((~(close | diff)).sum())} elements differ beyond "
            f"tolerance; max |diff| {np.abs(g - wt).max()}")
    report.max_abs_err = float(np.abs(g - wt)[~diff].max(initial=0.0))
    report.flipped_rows = int(diff.any(-1).sum())
    report.flips = [(int(m), 0, int(diff[m].sum()))
                    for m in np.flatnonzero(diff.any(-1))]
    return report


def compare_streams(got: Sequence, want: Sequence, *, flip_bound: float,
                    rtol: float = RTOL, atol: float = ATOL) -> TieReport:
    """Compare served logits stream by stream. ``got[i]``/``want[i]`` are
    one user's per-frame logits (frames, n_y), bursts concatenated in
    serving order. Frames before a stream's first differing frame match
    at tolerance; at that frame the logits may move by at most
    ``flip_bound`` (see :func:`one_level_logit_bound`), and the stream's
    later frames are not compared."""
    report = TieReport(rows=len(got))
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
        if a.shape != b.shape:
            raise AssertionError(f"stream {i}: shapes {a.shape} != {b.shape}")
        bad = np.flatnonzero(~np.isclose(a, b, rtol=rtol, atol=atol).all(-1))
        t0 = bad[0] if bad.size else a.shape[0]
        if t0:
            report.max_abs_err = max(report.max_abs_err,
                                     float(np.abs(a[:t0] - b[:t0]).max()))
        if t0 == a.shape[0]:
            continue
        jump = float(np.abs(a[t0] - b[t0]).max())
        if jump > flip_bound:
            raise AssertionError(
                f"stream {i} diverges at frame {t0} by {jump:.3g}, more "
                f"than one ADC level can move the logits ({flip_bound:.3g})")
        report.flipped_rows += 1
        report.flips.append((i, int(t0), 1))
    return report


def one_level_logit_bound(w_o, lam: float, adc_bits: int,
                          adc_range: float = 4.0) -> float:
    """Largest logit change one ADC level in one hidden unit can cause:
    tanh is 1-Lipschitz, so h moves by at most (1-λ)·step and each logit
    by that times the largest readout weight."""
    step = 2.0 * adc_range / 2 ** adc_bits
    return (1.0 - lam) * step * float(np.abs(_np(w_o)).max())
