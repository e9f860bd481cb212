"""K5's wide route (``csrc/hist.cu::lut_wide_kernel``: 2- and 4-byte table
entries, K = 1) on the CPU.  The kernel cannot run here; a NumPy mirror of
its plane split, warp chunks and shuffle schedule shows that every output
vector receives its own pixels, and that the planes it writes equal
``apply_lut256_plain``.

In a chunk, lane l holds the 16 pixels of input vector l (512 contiguous
pixels a warp); the warp writes G = sizeof(entry) stores of 512 contiguous
bytes, store k lane l taking output vector 32k + l.  In shuffle round m,
lane l reads, from lane (32/G)·((l % G + m) % G) + l / G, that lane's piece
(its lane index / (32/G) − m) % G: a 4-byte word of 4 pixels, or a pair of
words of 8 pixels.  The mirror moves pixel indices through the rounds as
``__shfl_sync`` does (each lane reads one register of another), so a piece
that lands in the wrong output vector shows as a wrong index.
"""

import numpy as np
import pytest
import torch

from imageenhancement_mp_tpu_torch.kernels import hist as khist

# csrc/hist.cu: kThreads, kWideLoads, kWideGrid
THREADS, LOADS, GRID = 256, 4, 8 * 132
WARPS = THREADS // 32


def shuffle_rounds(pieces: np.ndarray) -> np.ndarray:
    """``pieces`` ``[32, G, ...]`` (lane, piece) → ``[32, G, ...]`` (lane,
    store): what each lane stores in each store instruction, as the kernel's
    ``wide_chunk`` computes it."""
    G = pieces.shape[1]
    span = 32 // G
    lane = np.arange(32)
    got = []
    for m in range(G):
        # the sender's register this round: its piece (lane / span - m) % G
        send = pieces[lane, (lane // span - m) % G]
        src = span * ((lane % G + m) % G) + lane // G
        # each sender serves exactly one receiver per round
        assert sorted(src) == list(range(32))
        got.append(send[src])
    got = np.stack(got, axis=1)  # [32, rounds, ...]
    return got[lane[:, None], (np.arange(G)[None, :] - (lane % G)[:, None]) % G]


@pytest.mark.parametrize("G", [2, 4])
def test_every_output_vector_receives_its_own_pixels(G):
    P = 16 // G  # pixels per 16-byte output vector
    px = np.arange(512).reshape(32, G, P)  # lane l's vector: pixels 16l .. 16l + 15
    stored = shuffle_rounds(px)  # [32, G (store), P]
    for k in range(G):
        for lane in range(32):
            v = 32 * k + lane
            np.testing.assert_array_equal(stored[lane, k], np.arange(P * v, P * v + P))


def plane_split(addr_in: int, addr_out: int, n: int, G: int) -> tuple[int, int, int]:
    """``split_plane`` (head bytes to the input's 16-byte boundary, whole
    vectors, tail) and the kernel's test of the output's alignment."""
    head = min((16 - addr_in % 16) % 16, n)
    nvec = (n - head) // 16
    if (addr_out + head * G) % 16:
        return n, 0, n  # pixel by pixel
    return head, nvec, head + 16 * nvec


def grid(B: int, n: int) -> tuple[int, int]:
    grid_y = min(B, 65535)
    return max(1, min(GRID // grid_y, ((n >> 9) + WARPS) // WARPS)), grid_y


def kernel_mirror(x: np.ndarray, lut: np.ndarray, addr_in: int, addr_out: int) -> np.ndarray:
    """The kernel on ``[B, n]`` u8 planes at byte address ``addr_in`` (mod
    16) with ``[B, 256]`` tables, its output at ``addr_out``: per plane the
    warps' chunks (kWideLoads a trip, strided by the grid's warps), the
    shuffle schedule and the per-pixel head and tail; each output pixel
    written exactly once."""
    B, n = x.shape
    G = lut.dtype.itemsize
    P = 16 // G
    per_plane, _ = grid(B, n)
    nwarps = per_plane * WARPS
    out = np.zeros((B, n), lut.dtype)
    writes = np.zeros((B, n), np.int64)
    for b in range(B):
        head, nvec, tail = plane_split(addr_in + b * n, addr_out + b * n * G, n, G)
        nchunks = -(-nvec // 32)
        for w in range(nwarps):
            for c0 in range(w, nchunks, nwarps * LOADS):
                for u in range(LOADS):
                    c = c0 + u * nwarps
                    if c >= nchunks:
                        continue
                    vec = 32 * c + np.arange(32)
                    # each lane's 16 pixel indices (lanes past the body hold zeros)
                    idx = np.where((vec < nvec)[:, None], head + 16 * vec[:, None]
                                   + np.arange(16), 0)
                    stored = shuffle_rounds(idx.reshape(32, G, P)).transpose(1, 0, 2)
                    # store k, lane l: output vector 32k + l of the chunk, if in the body
                    ov = (32 * np.arange(G)[:, None] + np.arange(32)[None, :])
                    ok = ov < (nvec - 32 * c) * G
                    at = head + P * (32 * c * G + ov[..., None]) + np.arange(P)
                    np.testing.assert_array_equal(stored[ok], at[ok])
                    out[b, at[ok]] = lut[b, x[b, stored[ok]]]
                    np.add.at(writes[b], at[ok].reshape(-1), 1)
        rest = np.r_[0:head, tail:n]
        out[b, rest] = lut[b, x[b, rest]]
        writes[b, rest] += 1
    assert (writes == 1).all()
    return out


# (B, n): below one warp's 512 bytes, odd, heads and tails, several chunks
# and trips, chunks that end inside a warp
SHAPES = [(1, 1), (2, 15), (3, 17), (1, 255), (2, 511), (1, 512), (2, 513), (3, 1000),
          (1, 16 * 32 * 3 + 7), (2, 8191), (1, 8192 + 16 * 5 + 3), (1, 300_001)]


@pytest.mark.parametrize("dtype", [np.uint16, np.int16, np.int32, np.float32])
@pytest.mark.parametrize("B,n", SHAPES)
@pytest.mark.parametrize("offset", [0, 1, 4, 8, 12])
def test_kernel_mirror_equals_plain(dtype, B, n, offset):
    """A contiguous view at a storage offset of ``offset`` bytes, the output
    freshly allocated (16-byte aligned): offset 0 (and 8, or 4 and 12 for
    4-byte entries) keeps the vector route with a head; the others go pixel
    by pixel."""
    rng = np.random.default_rng(n * 7 + offset)
    x = rng.integers(0, 256, (B, n), dtype=np.uint8)
    if dtype == np.float32:
        lut = rng.standard_normal((B, 256)).astype(np.float32)
        bits = lut.view(np.uint32)
        # NaN payloads, an infinity, a subnormal
        bits[:, :4] = [0x7FC00001, 0xFFBADBAD, 0x7F800000, 0x00000001]
    else:
        info = np.iinfo(dtype)
        lut = rng.integers(info.min, info.max + 1, (B, 256)).astype(dtype)
    got = kernel_mirror(x, lut, offset, 0)
    want = khist.apply_lut256_plain(torch.from_numpy(x), torch.from_numpy(lut)).numpy()
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    G = lut.dtype.itemsize
    vector = offset % (16 // G) == 0
    assert (plane_split(offset, 0, n, G)[1] > 0) == (vector and n - (16 - offset) % 16 >= 16)


def test_grid_covers_every_chunk_once():
    for B, n in [(1, 1), (8, 1080 * 1920), (70000, 64), (1, 2_200_000 * 8), (3, 513)]:
        per_plane, grid_y = grid(B, n)
        assert 1 <= per_plane and per_plane * grid_y <= max(GRID, grid_y) and grid_y <= 65535
        nchunks = -(-(n // 16) // 32)
        nwarps = per_plane * WARPS
        seen = np.zeros(nchunks, np.int64)
        for w in range(nwarps):
            for c0 in range(w, nchunks, nwarps * LOADS):
                for u in range(LOADS):
                    if c0 + u * nwarps < nchunks:
                        seen[c0 + u * nwarps] += 1
        assert (seen == 1).all()
