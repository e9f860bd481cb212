"""Pyramidal Lucas-Kanade sparse optical flow: ``cv2.calcOpticalFlowPyrLK``
on grayscale u8 frames, every point tracked at once.

The JAX package's ``ops/lk.py`` in plain PyTorch on the input's device.
The law, pinned to ``ref/ops.py::calc_optical_flow_pyr_lk`` (lkpyramid.cpp):
per level from the coarsest, the image padded REFLECT_101 and its Scharr
derivatives CONSTANT 0 by the window; Q14 bilinear taps
``iw = cvRound(w·2^14)`` with the last weight closing the sum, the patch
descaled by ``>> 9`` and the derivatives by ``>> 14``; the structure tensor
and mismatch vector summed in cv2's SIMD lane order and scaled by 2^-20; a
plain-f32 2×2 solve, the 0.01 flip-flop damper on f32 sums compared in
f64, the min-eigenvalue gate, and the L1 error divided by ``f32(32·area)``.

``exact=True`` reproduces cv2's lane accumulation (:func:`lane_sum_exact`):
8-wide blocks feed four f32 lanes through single-rounded FMAs (the f64 sum
of an exact integer product and an f32 lane, rounded once), the leftover
columns add in f32 row by row, then ``tail + ((l0 + l2) + (l1 + l3))``.  Its
order may not change, so it runs over the window's steps and is vectorised
over points (and over the sums that share a window).  ``exact=False`` sums
each window in one free-order reduction.  The iteration runs ``max_count``
times with per-point freeze masks and never reads the device.
"""

from __future__ import annotations

import torch

__all__ = ["scharr_deriv", "lane_sum_exact", "lane_sum_fast", "calc_optical_flow_pyr_lk_planes"]

_W_BITS = 14
_FLT_SCALE = 1.0 / (1 << 20)
_F32_EPS = 1.1920928955078125e-07


def scharr_deriv(img: torch.Tensor) -> torch.Tensor:
    """cv2's ``calcSharrDeriv``: int32 ``[H, W, 2]`` (dx, dy) of a 2-D u8
    image, [3, 10, 3] smoothing and [−1, 0, 1] difference, REFLECT_101 edge
    rows and columns."""
    H, W = img.shape
    s = img.to(torch.int32)
    up = torch.cat([s[1:2], s[:-1]], 0) if H > 1 else s
    dn = torch.cat([s[1:], s[-2:-1]], 0) if H > 1 else s
    t0 = (up + dn) * 3 + s * 10
    t1 = dn - up

    def hsh(A):
        left = torch.cat([A[:, 1:2], A[:, :-1]], 1) if W > 1 else A
        right = torch.cat([A[:, 1:], A[:, -2:-1]], 1) if W > 1 else A
        return left, right

    l0, r0 = hsh(t0)
    l1, r1 = hsh(t1)
    return torch.stack([r0 - l0, (l1 + r1) * 3 + t1 * 10], -1)


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """The oracle's one-fold REFLECT_101 index over ``[-pad, n + pad)``."""
    i = torch.arange(-pad, n + pad, device=device).abs()
    i = torch.where(i >= n, 2 * (n - 1) - i, i)
    return torch.where(i < 0, i + n, i)


def _pad_image(img: torch.Tensor, ww: int, wh: int) -> torch.Tensor:
    """The level as int32, padded REFLECT_101 by the window, as
    buildOpticalFlowPyramid allocates it."""
    H, W = img.shape
    yi, xi = _reflect_index(H, wh, img.device), _reflect_index(W, ww, img.device)
    return img.to(torch.int32)[yi[:, None], xi[None, :]]


def _pad_derivs(img: torch.Tensor, ww: int, wh: int) -> torch.Tensor:
    """The level's Scharr derivatives, int32, padded CONSTANT 0 by the window."""
    H, W = img.shape
    D = torch.zeros((H + 2 * wh, W + 2 * ww, 2), dtype=torch.int32, device=img.device)
    D[wh:wh + H, ww:ww + W] = scharr_deriv(img)
    return D


def lane_sum_exact(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """cv2's ``v_muladd`` lane accumulation of ``Σ A·B`` over int32 windows
    ``[..., wh, ww]`` → ``[...]`` f32, in cv2's order (see the module)."""
    wh, ww = A.shape[-2], A.shape[-1]
    lead = A.shape[:-2]
    nb = ww // 8
    vw = nb * 8
    red = torch.zeros(lead, dtype=torch.float32, device=A.device)
    if nb:
        # lane l takes block positions l and l + 4: steps ordered by (row,
        # block, half), the four lanes side by side
        P = (A[..., :vw].to(torch.float64) * B[..., :vw].to(torch.float64)).reshape(
            lead + (wh * nb * 2, 4))
        lanes = torch.zeros(lead + (4,), dtype=torch.float32, device=A.device)
        for s in range(P.shape[-2]):
            lanes = (P[..., s, :] + lanes).to(torch.float32)
        red = (lanes[..., 0] + lanes[..., 2]) + (lanes[..., 1] + lanes[..., 3])
    tail = torch.zeros(lead, dtype=torch.float32, device=A.device)
    if vw < ww:
        Pt = (A[..., vw:] * B[..., vw:]).to(torch.float32).reshape(lead + (-1,))
        for t in range(Pt.shape[-1]):
            tail = tail + Pt[..., t]
    return tail + red


def lane_sum_fast(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``Σ A·B`` over the window in one free-order f32 reduction."""
    return (A * B).to(torch.float32).sum((-2, -1))


def _div32(a: torch.Tensor, b) -> torch.Tensor:
    """The correctly rounded f32 quotient (an f64 quotient of two f32 values
    rounds once more innocuously), always tensor by tensor."""
    b = b if isinstance(b, torch.Tensor) else torch.full_like(a, float(b))
    return (a.to(torch.float64) / b.to(torch.float64)).to(torch.float32)


def _weights(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """Q14 bilinear weights of fractions ``a``, ``b`` ([N] f32) → int32."""
    one = 1.0
    iw00 = torch.round((one - a) * (one - b) * (1 << _W_BITS)).to(torch.int32)
    iw01 = torch.round(a * (one - b) * (1 << _W_BITS)).to(torch.int32)
    iw10 = torch.round((one - a) * b * (1 << _W_BITS)).to(torch.int32)
    iw11 = (1 << _W_BITS) - iw00 - iw01 - iw10
    return iw00, iw01, iw10, iw11


def _window(P: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor, ww: int, wh: int,
            H: int, W: int) -> torch.Tensor:
    """The ``(wh+1, ww+1)`` windows of the padded level ``P`` at level
    coordinates ``(ix, iy)`` ([N] int64), starts clamped inside the pad."""
    y0 = (iy + wh).clamp(0, H + wh - 1)
    x0 = (ix + ww).clamp(0, W + ww - 1)
    rows = y0[:, None] + torch.arange(wh + 1, device=P.device)
    cols = x0[:, None] + torch.arange(ww + 1, device=P.device)
    return P[rows[:, :, None], cols[:, None, :]]


def _interp(Wnd: torch.Tensor, iws: tuple, shift: int) -> torch.Tensor:
    shape = (-1, 1, 1) + (1,) * (Wnd.dim() - 3)
    w = [t.reshape(shape) for t in iws]
    s = (Wnd[:, :-1, :-1] * w[0] + Wnd[:, :-1, 1:] * w[1]
         + Wnd[:, 1:, :-1] * w[2] + Wnd[:, 1:, 1:] * w[3])
    return (s + (1 << (shift - 1))) >> shift


def _outside(ip: torch.Tensor, ww: int, wh: int, H: int, W: int) -> torch.Tensor:
    return (ip[:, 0] < -ww) | (ip[:, 0] >= W) | (ip[:, 1] < -wh) | (ip[:, 1] >= H)


def calc_optical_flow_pyr_lk_planes(prev_levels: list, next_levels: list,
                                    prev_pts: torch.Tensor, win_size, max_level: int,
                                    max_count: int, epsilon: float, min_eig_threshold: float,
                                    exact: bool = True):
    """Track ``prev_pts`` ([N, 2] f32) through two pyramids (lists of u8
    ``[H, W]`` levels, finest first) → ``(next_pts f32 [N, 2], status u8
    [N], err f32 [N])``."""
    f32 = torch.float32
    dev = prev_pts.device
    ww, wh = int(win_size[0]), int(win_size[1])
    lane_sum = lane_sum_exact if exact else lane_sum_fast
    half = torch.tensor([(ww - 1) * 0.5, (wh - 1) * 0.5], dtype=f32, device=dev)
    crit_cnt = min(max(int(max_count), 0), 100)
    eps = min(max(float(epsilon), 0.0), 10.0)
    eps *= eps
    max_level = min(int(max_level), len(prev_levels) - 1, len(next_levels) - 1)
    pts = prev_pts.to(f32)
    N = pts.shape[0]
    out = torch.zeros((N, 2), dtype=f32, device=dev)
    status = torch.ones(N, dtype=torch.uint8, device=dev)
    err = torch.zeros(N, dtype=f32, device=dev)
    area = torch.full((N,), float(2 * ww * wh), dtype=f32, device=dev)
    for level in range(max_level, -1, -1):
        H, W = prev_levels[level].shape
        HB, WB = next_levels[level].shape
        I, DI = _pad_image(prev_levels[level], ww, wh), _pad_derivs(prev_levels[level], ww, wh)
        J = _pad_image(next_levels[level], ww, wh)
        prevPt = pts * (1.0 / (1 << level))
        nextPt = prevPt if level == max_level else out * 2.0
        pPt = prevPt - half
        ipf = torch.floor(pPt)
        ip = ipf.to(torch.int64)
        p_out = _outside(ip, ww, wh, H, W)
        ab = pPt - ipf
        iws = _weights(ab[:, 0], ab[:, 1])
        ival = _interp(_window(I, ip[:, 1], ip[:, 0], ww, wh, H, W), iws, _W_BITS - 5)
        dval = _interp(_window(DI, ip[:, 1], ip[:, 0], ww, wh, H, W), iws, _W_BITS)
        ixv, iyv = dval[..., 0], dval[..., 1]
        A = lane_sum(torch.stack([ixv, ixv, iyv]), torch.stack([ixv, iyv, iyv])) * _FLT_SCALE
        A11, A12, A22 = A[0], A[1], A[2]
        D0 = A11 * A22 - A12 * A12
        t = A11 - A22
        root = torch.sqrt((t * t + (4.0 * A12) * A12).to(torch.float64)).to(f32)
        min_eig = _div32((A22 + A11) - root, area)
        bad = (min_eig < float(min_eig_threshold)) | (D0 < _F32_EPS)
        Dk = _div32(torch.ones_like(D0), D0)
        nPt = nextPt - half
        outp = nextPt
        active = ~(p_out | bad)
        broke = torch.zeros(N, dtype=torch.bool, device=dev)
        prev_d = torch.zeros((N, 2), dtype=f32, device=dev)
        for j in range(crit_cnt):
            inpf = torch.floor(nPt)
            inp = inpf.to(torch.int64)
            outside = _outside(inp, ww, wh, HB, WB)
            hit = active & outside
            if level == 0:
                status = torch.where(hit, torch.zeros_like(status), status)
            broke = broke | hit
            active = active & ~outside
            fr = nPt - inpf
            jval = _interp(_window(J, inp[:, 1], inp[:, 0], ww, wh, HB, WB),
                           _weights(fr[:, 0], fr[:, 1]), _W_BITS - 5)
            diff = jval - ival
            b = lane_sum(torch.stack([diff, diff]), torch.stack([ixv, iyv])) * _FLT_SCALE
            b1, b2 = b[0], b[1]
            dx = (A12 * b2 - A22 * b1) * Dk
            dy = (A12 * b1 - A11 * b2) * Dk
            delta = torch.stack([dx, dy], -1)
            act = active[:, None]
            nPt = torch.where(act, nPt + delta, nPt)
            outp = torch.where(act, nPt + half, outp)
            dx64, dy64 = dx.to(torch.float64), dy.to(torch.float64)
            conv = dx64 * dx64 + dy64 * dy64 <= eps
            # the damper sums in f32 and compares with the double 0.01
            s = (delta + prev_d).to(torch.float64).abs()
            flip = (s[:, 0] < 0.01) & (s[:, 1] < 0.01) if j > 0 else torch.zeros_like(conv)
            outp = torch.where((active & ~conv & flip)[:, None], outp - delta * 0.5, outp)
            prev_d = torch.where(act, delta, prev_d)
            active = active & ~(conv | flip)
        outF = torch.where((p_out | bad)[:, None], nextPt, outp)
        if level == 0:
            zero_st = torch.zeros_like(status)
            status = torch.where(p_out | bad, zero_st, status)
            err = torch.where(p_out, torch.zeros_like(err), err)
            nPtE = outF - half
            ipef = torch.floor(nPtE)
            ipe = ipef.to(torch.int64)
            eout = _outside(ipe, ww, wh, HB, WB)
            fr = nPtE - ipef
            jval = _interp(_window(J, ipe[:, 1], ipe[:, 0], ww, wh, HB, WB),
                           _weights(fr[:, 0], fr[:, 1]), _W_BITS - 5)
            adiff = (jval - ival).to(f32).abs().reshape(N, -1)
            if exact:
                esum = torch.zeros(N, dtype=f32, device=dev)
                for k in range(adiff.shape[1]):
                    esum = esum + adiff[:, k]
            else:
                esum = adiff.sum(-1)
            ev = _div32(esum, float(32 * ww * wh))
            live = (status == 1) & ~broke & ~p_out & ~bad
            status = torch.where(live & eout, zero_st, status)
            err = torch.where(live & eout, torch.zeros_like(err), torch.where(live, ev, err))
        out = outF
    return out, status, err
