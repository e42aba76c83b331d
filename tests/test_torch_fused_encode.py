"""K4's thread map and byte ownership on the CPU (``csrc/fused_encode.cu``),
and the choice between its two routes.

The CUDA kernel runs only on the card, where ``chip_smoke.py`` holds its
bytes against the plain version.  What can go wrong without showing in a
plain version is the split: which thread holds which coordinate, and which
thread writes which packed byte when a pair of coordinates straddles two
threads.  The model here follows the kernel's code: K1's grid (P, rows) of
256 threads, the row peeled to a 16-byte boundary (its head), 16-byte
vectors tid, tid + stride, ... (slots), the tail; the two-launch route's
16-byte quantize (its unpacked rows) walks the same map over its own grid,
in trips.  (Its packed rows go through a kernel where thread j writes byte
j from coordinates 2j, 2j + 1: one writer a byte by construction.)  Inputs
come from numpy with fixed seeds."""
import re

import numpy as np
import pytest
import torch

from repro_torch.compress.wire import pack_int4
from repro_torch.kernels import build
from repro_torch.kernels import fused_encode as FE
from repro_torch.kernels import qsgd as K


def _constant(name):
    """An integer constant of csrc/fused_encode.cu."""
    with open(f"{build.CSRC_DIR}/fused_encode.cu") as f:
        return int(re.search(rf"constexpr (?:unsigned )?int {name} = (\d+);",
                             f.read()).group(1))


THREADS = 256
#: vectors a thread holds on the one-launch route, and a trip of the
#: two-launch route's quantize
SLOTS, QUANT_SLOTS = _constant("kSlots"), _constant("kQuantSlots")
#: the quantize's grid is one wave of the card shared by the rows: 792
#: blocks on 132 SMs at 6 an SM, and a small wave that forces many trips
WAVES = (792, 5)
NS = [1, 2, 3, 5, 127, 2049, 101770, 2**16 + 3, 2**17]


def _row_map(offset, n, blocks):
    """The RowMap of a row starting ``offset`` floats past a 16-byte
    boundary, over ``blocks`` blocks: (head, nvec, stride)."""
    head = min((4 - offset % 4) % 4, n)
    return head, (n - head) // 4, blocks * THREADS


def _held(offset, n, blocks, slots):
    """The coordinates the threads hold, from the threads' side, as the
    kernel loads them (``load_held``): each thread's head element, its
    vectors in slots 0 .. slots - 1 (over all its trips) and its tail
    element, one entry per (thread, slot, coordinate)."""
    head, nvec, stride = _row_map(offset, n, blocks)
    tid = np.arange(stride)
    parts = [tid[tid < head]]
    for slot in range(slots):
        i = tid + slot * stride
        parts += [head + 4 * i[i < nvec] + e for e in range(4)]
    t = head + 4 * nvec + tid
    parts.append(t[t < n])
    return np.concatenate(parts)


def _owned_bytes(offset, n, blocks, slots, lvl, level_at):
    """The packed bytes each thread writes (``store_held``): a vector at an
    even c0 writes bytes (c0, c0+1), (c0+2, c0+3); at an odd c0 bytes
    (c0+1, c0+2), (c0+3, c0+4), the level of c0 + 4 recomputed from y and
    u (``level_at``); an even head or tail element c writes (c, c+1), the
    level of c + 1 recomputed.  ``lvl`` holds the levels a thread computes
    from its own registers.  -> (byte index, byte value) arrays."""
    head, nvec, stride = _row_map(offset, n, blocks)
    tid = np.arange(stride)
    idx, val = [], []

    def pack(lo, hi):
        return ((lo & 0xF) | ((hi & 0xF) << 4)).astype(np.uint8)

    for slot in range(slots):
        i = tid + slot * stride
        c0 = head + 4 * i[i < nvec]
        ev, od = c0[c0 % 2 == 0], c0[c0 % 2 == 1]
        idx += [ev // 2, ev // 2 + 1, (od + 1) // 2, (od + 1) // 2 + 1]
        val += [pack(lvl[ev], lvl[ev + 1]), pack(lvl[ev + 2], lvl[ev + 3]),
                pack(lvl[od + 1], lvl[od + 2]),
                pack(lvl[od + 3], level_at(od + 4))]
    edges = np.concatenate([tid[tid < head], head + 4 * nvec + tid])
    edges = edges[(edges < n) & (edges % 2 == 0)]
    idx.append(edges // 2)
    val.append(pack(lvl[edges], level_at(edges + 1)))
    return np.concatenate(idx), np.concatenate(val)


def _routes(rows, n, wave=WAVES[0]):
    """(name, blocks, slots) of K4's RowMap kernels for a row of a (rows, n)
    matrix: the one launch, K1's P with SLOTS vectors a thread, and the
    two-launch route's 16-byte quantize, its grid (``grid_x`` of n over 4 *
    QUANT_SLOTS * THREADS, at most ``wave // rows``) with as many trips of
    QUANT_SLOTS as the row needs."""
    P = K.sumsq_blocks(n)
    X = max(1, min(max(1, wave // rows), -(-n // (4 * QUANT_SLOTS * THREADS))))
    trips = max(1, -(-(n // 4) // (QUANT_SLOTS * X * THREADS)))
    return ("one_launch", P, SLOTS), ("two_launch", X, QUANT_SLOTS * trips)


@pytest.mark.parametrize("phase", [0, 1, 2, 3])
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("rows", [1, 3])
def test_k4_split_owns_each_byte_once(rows, n, phase):
    """For a (rows, n) matrix starting ``phase`` floats past a 16-byte
    boundary, on both routes: every coordinate is held by exactly one
    (block, thread, slot), at most 4 vectors a thread on the one-launch
    route; every packed byte has exactly one writer; and the bytes built
    under that ownership, straddling neighbours recomputed from y and u,
    equal ``pack_int4(quantize_plain(...))``."""
    _check_split(rows, n, phase, _routes(rows, n))


@pytest.mark.parametrize("phase", [0, 1, 2, 3])
@pytest.mark.parametrize("rows", [1, 3])
def test_k4_two_launch_trips(rows, phase):
    """A wave small enough that the two-launch route's quantize takes
    several trips a thread: the same three facts."""
    n = 2**16 + 3
    routes = [r for r in _routes(rows, n, WAVES[1]) if r[0] == "two_launch"]
    assert routes[0][2] > QUANT_SLOTS                     # several trips
    _check_split(rows, n, phase, routes)


def _check_split(rows, n, phase, routes):
    rng = np.random.default_rng(n * 4 + phase)
    y = torch.from_numpy((rng.standard_normal((rows, n)) * 3).astype(
        np.float32))
    u = torch.from_numpy(rng.random((rows, n), dtype=np.float32))
    s = 7
    inv = K.sumsq_plain(y, s)[2]
    want = pack_int4(K.quantize_plain(y, u, inv, s)).numpy().view(np.uint8)
    m = (n + 1) // 2
    for r in range(rows):
        offset = phase + r * n
        lvl = K.quantize_plain(y[r:r + 1], u[r:r + 1], inv[r:r + 1],
                               s)[0].numpy().astype(np.int32)

        def level_at(c):
            """The level of coordinate c from y and u, 0 past n."""
            c = np.asarray(c)
            got = np.zeros(c.shape, np.int32)
            ok = c < n
            got[ok] = K.quantize_plain(
                y[r:r + 1, c[ok]], u[r:r + 1, c[ok]], inv[r:r + 1],
                s)[0].numpy()
            return got

        for route, blocks, slots in routes:
            coord = _held(offset, n, blocks, slots)
            assert np.array_equal(np.bincount(coord, minlength=n),
                                  np.ones(n, np.int64)), route
            idx, val = _owned_bytes(offset, n, blocks, slots, lvl, level_at)
            assert np.array_equal(np.bincount(idx, minlength=m),
                                  np.ones(m, np.int64)), route
            got = np.zeros(m, np.uint8)
            got[idx] = val
            np.testing.assert_array_equal(got, want[r], err_msg=route)


@pytest.mark.parametrize("n", [2**22 - 1, 2**22, 4096 * 1000 + 3, 2**19,
                               4097, 5])
@pytest.mark.parametrize("phase", [0, 1, 2, 3])
def test_k4_one_launch_holds_at_most_four_vectors(n, phase):
    """Up to n = 2^22, K1's grid of sumsq_blocks(n) blocks gives each
    thread at most 4 vectors of the row (the kernel's kSlots), whatever
    its head; the route asks it for no longer rows."""
    head, nvec, stride = _row_map(phase, n, K.sumsq_blocks(n))
    assert nvec <= SLOTS * stride
    assert FE.K4_ONE_LAUNCH_MAX_N <= 2**22


def test_k4_route():
    """The route is a pure function of (rows, n, capacity): one launch for
    the 10 worker deltas at D on a card holding 528 blocks, two above
    2^19 coordinates (128 blocks a row) or above the card's resident
    blocks."""
    D = 101770
    assert FE.k4_route(10, D, 528) == "one_launch"
    assert [FE.k4_route(10, D, 528) for _ in range(3)] == ["one_launch"] * 3
    assert FE.k4_route(10, D, 249) == "two_launch"      # 10 x 25 blocks
    assert FE.k4_route(10, 2**17, 320) == "one_launch"
    assert FE.k4_route(10, 2**17, 319) == "two_launch"
    assert FE.k4_route(1, 2**19, 128) == "one_launch"
    assert FE.k4_route(1, 2**19 + 1, 10**9) == "two_launch"
    assert FE.k4_route(1, 2**20, 528) == "two_launch"    # 256 blocks a row
    assert FE.k4_route(1, 2**22, 10**9) == "two_launch"
    assert FE.k4_route(1, 1, 1) == "one_launch"


def test_k4_routes_counted_only_on_the_card():
    """A CPU call runs the plain version and counts no launch and no
    route."""
    FE.reset_launches()
    y = torch.zeros(2, 9)
    FE.fused_encode(y, y, 7, pack=True)
    assert FE.LAUNCHES["fused_encode"] == 0
    assert FE.ROUTES == dict.fromkeys(FE.ROUTES, 0)
