"""Kernel B6's host side on the CPU: the table block its stage kernels
read (``x11_cuda.table_block``: groestl's and AES's T-tables replicated
across the shared-memory banks, and the small tables) against the port's
host tier, the lookups as the kernels address them, simd's NTT as each
thread of a lane's group of 8 computes it, the chunk plan of the launch
sequence, the bound's instruction counts, and the wrappers raising
without a card. The kernels themselves run only on the card
(``chip_smoke.py`` phases 1 and 29-33)."""

from __future__ import annotations

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from otedama_tpu_torch.kernels import x11_cuda, x11_torch

M32 = 0xFFFFFFFF
SRC = (Path(__file__).resolve().parents[1]
       / "otedama_tpu_torch/kernels/csrc/x11.cu").read_text()


@functools.lru_cache(maxsize=1)
def _block() -> np.ndarray:
    return x11_cuda.table_block()


def _region(name: str) -> np.ndarray:
    at = x11_cuda.table_offsets()[name]
    return _block()[at:at + dict(x11_cuda.TABLE_LAYOUT)[name]]


def _u64(a) -> np.ndarray:
    return np.asarray(a, dtype=np.uint64)


def _rotl64(x, n: int):
    x = _u64(x)
    return (x << np.uint64(n)) | (x >> np.uint64(64 - n))


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr \w+ {name} = (\d+)u?;", SRC).group(1))


# -- the table block ---------------------------------------------------------------

def test_groestl_tables_are_replicated_and_tables_4_to_7_are_half_swaps():
    gro = x11_torch.groestl_tables()
    # the kernel reads tables 4-7 as tables 0-3 with their halves swapped
    for t in range(4):
        assert np.array_equal(gro[t + 4], _rotl64(gro[t], 32))
    block = _region("groestl").view(np.uint64).reshape(
        4, 256, x11_cuda.GROESTL_COPIES)
    for copy in range(x11_cuda.GROESTL_COPIES):
        assert np.array_equal(block[:, :, copy], gro[:4])


def test_aes_tables_are_rotations_replicated_32_times():
    t0 = x11_torch.aes_table().astype(np.uint64)
    block = _region("aes").reshape(4, 256, x11_cuda.AES_COPIES)
    plain = x11_torch._t("aes", "cpu").numpy()
    for t in range(4):
        rot = ((t0 << (8 * t)) | (t0 >> (32 - 8 * t))) & M32
        assert np.array_equal(plain[t], rot)
        for copy in range(x11_cuda.AES_COPIES):
            assert np.array_equal(block[t, :, copy], rot)


def test_small_tables_equal_the_host_tier():
    iv, consts = x11_torch.jh_tables()
    simd = x11_torch.simd_tables()
    assert np.array_equal(_region("jh_iv").view(np.uint64), iv)
    assert np.array_equal(_region("jh_c").view(np.uint64),
                          consts.reshape(-1))
    assert np.array_equal(_region("cube_iv"), x11_torch.cubehash_iv())
    assert np.array_equal(_region("twist"), simd["twist"])
    assert np.array_equal(_region("w_final"),
                          simd["w_final"].astype(np.uint32))
    c = _region("simd_c").reshape(64, 8)
    assert all(int(c[n, j]) == pow(41, n * j, 257)
               for n in range(64) for j in range(8))


def test_table_layout_and_launch_shapes_match_the_kernel_source():
    offsets = {k: int(v) for k, v in
               re.findall(r"constexpr int k(\w+)Off = (\d+);", SRC)}
    at = x11_cuda.table_offsets()
    assert offsets == {"Gro": at["groestl"], "Aes": at["aes"],
                       "JhIv": at["jh_iv"], "JhC": at["jh_c"],
                       "CubeIv": at["cube_iv"], "SimdC": at["simd_c"],
                       "Twist": at["twist"], "WFinal": at["w_final"]}
    assert _constant("kTableWords") == x11_cuda.TABLE_WORDS == _block().size
    # each replicated region is what a block copies into shared memory
    assert _constant("kTabBytes") == 4 * dict(x11_cuda.TABLE_LAYOUT)["aes"] \
        == 4 * dict(x11_cuda.TABLE_LAYOUT)["groestl"]
    assert at["groestl"] % 4 == 0 and at["aes"] % 4 == 0   # 16-byte copies
    assert at["jh_iv"] % 2 == 0 and at["jh_c"] % 2 == 0    # 64-bit words
    assert _constant("kRowBytes") == x11_cuda.ROW_BYTES
    assert _constant("kThreads") == x11_cuda.THREADS
    assert _constant("kTabThreads") == x11_cuda.TABLE_THREADS
    assert _constant("kSimdGroup") == x11_cuda.SIMD_GROUP
    assert _constant("kJobWords") == x11_cuda.JOB_WORDS


# -- the lookups as the kernels address them -------------------------------------------

def _lookup(region: str, entry_bytes: int, t: int, x, copy: int):
    """A lookup at byte t * 32768 + x * ROW_BYTES + copy * entry_bytes of
    the region, as the kernels' gro_ld and aes_ld address it."""
    raw = _region(region).view(np.uint8)
    at = t * 32768 + np.asarray(x, dtype=np.int64) * x11_cuda.ROW_BYTES \
        + copy * entry_bytes
    words = np.stack([raw[at + i] for i in range(entry_bytes)], -1)
    return words.copy().view("<u8" if entry_bytes == 8 else "<u4")[..., 0]


def _groestl_perm_block(x: np.ndarray, q: bool, copy: int) -> np.ndarray:
    """groestl_perm of csrc/x11.cu over [B, 16] uint64 columns."""
    shift = ((1, 3, 5, 11, 0, 2, 4, 6) if q else (0, 1, 2, 3, 4, 5, 6, 11))
    cols = np.arange(16, dtype=np.uint64) << np.uint64(4)
    for r in range(14):
        if q:
            x = ~x ^ ((cols ^ np.uint64(r)) << np.uint64(56))
        else:
            x = x ^ (cols ^ np.uint64(r))
        t = np.zeros_like(x)
        for c in range(16):
            a = np.zeros(x.shape[0], np.uint64)
            b = np.zeros(x.shape[0], np.uint64)
            for i in range(8):
                byte = (x[:, (c + shift[i]) % 16] >> np.uint64(8 * i)) & np.uint64(0xFF)
                v = _lookup("groestl", 8, i % 4, byte, copy)
                if i < 4:
                    a ^= v
                else:
                    b ^= v
            t[:, c] = a ^ _rotl64(b, 32)
        x = t
    return x


@pytest.mark.parametrize("q", [False, True])
def test_groestl_through_the_replicated_block_equals_the_plain_permutation(q):
    rng = np.random.default_rng(12 + q)
    x = rng.integers(0, 1 << 63, (3, 16), dtype=np.uint64) * np.uint64(2) \
        + rng.integers(0, 2, (3, 16), dtype=np.uint64)
    plain = x11_torch._groestl_perm(torch.from_numpy(x.view(np.int64)), q)
    for copy in (0, 7, 15):
        got = _groestl_perm_block(x, q, copy)
        assert np.array_equal(got, plain.numpy().view(np.uint64)), copy


def test_aes_round_through_the_replicated_block_equals_the_plain_round():
    rng = np.random.default_rng(21)
    x = rng.integers(0, 1 << 32, (64, 4), dtype=np.uint64).astype(np.uint32)
    plain = x11_torch._aes(torch.from_numpy(x.astype(np.int64))).numpy()
    for copy in (0, 13, 31):
        y = np.zeros_like(x)
        for w in range(4):
            for t in range(4):
                byte = (x[:, (w + t) % 4] >> np.uint32(8 * t)) & np.uint32(0xFF)
                y[:, w] ^= _lookup("aes", 4, t, byte, copy)
        assert np.array_equal(y.astype(np.int64), plain), copy


# -- simd's NTT, a thread of the group at a time ---------------------------------------

def _red(x: int) -> int:
    return (x & 255) - (x >> 8)


def _rev5(i: int) -> int:
    return int(f"{i:05b}"[::-1], 2)


def _simd_expand_j(xb: list[int], j: int, w8: list[int], seen: list[int]):
    """simd_expand_j of csrc/x11.cu for thread j: y[j + 8m], m < 32."""
    c = _region("simd_c").reshape(64, 8)[:, j].astype(int)
    twist = _region("twist").astype(int)
    y = [_red(xb[b] * c[b] + xb[32 + b] * c[32 + b])
         for b in (_rev5(i) for i in range(32))]
    for lg in range(5):
        for q in range(16):
            i = q & ((1 << lg) - 1)
            lo = ((q >> lg) << (lg + 1)) + i
            hi = lo + (1 << lg)
            e = i << (4 - lg)
            t = y[hi] if e == 0 else _red(y[hi] * w8[e])
            seen += [abs(y[hi] * w8[e]), abs(y[lo] + t), abs(y[lo] - t)]
            y[lo], y[hi] = y[lo] + t, y[lo] - t
    out = []
    for m in range(32):
        p = y[m] * int(twist[j + 8 * m])
        seen.append(abs(p))
        v = _red(_red(_red(p)))
        assert -1 <= v <= 256
        out.append(v - 257 if v > 128 else v)
    return out


@pytest.mark.parametrize("case", ["zeros", "ones", "random"])
def test_simd_group_ntt_equals_the_plain_expansion(case):
    w8 = [int(v) for v in re.search(r"kW8\[32\] = \{(.*?)\};", SRC,
                                    re.S).group(1).replace(",", " ").split()]
    assert w8 == [pow(41, 8 * e, 257) for e in range(32)]
    rng = np.random.default_rng(5)
    xb = {"zeros": [0] * 64, "ones": [255] * 64,
          "random": [int(v) for v in rng.integers(0, 256, 64)]}[case]
    seen: list[int] = []
    s = [0] * 256
    for j in range(x11_cuda.SIMD_GROUP):
        for m, v in enumerate(_simd_expand_j(xb, j, w8, seen)):
            s[j + 8 * m] = v
    # thread j packs the words of its column: y[j + 8m] and y[j + 8(m ^ 16)]
    words = [(s[i] & 0xFFFF) | ((s[i ^ 128] & 0xFFFF) << 16)
             for i in range(256)]
    x = torch.zeros(1, 128, dtype=torch.int64)
    x[0, :64] = torch.tensor(xb)
    assert words == x11_torch._simd_expand(x)[0].tolist()
    assert max(seen) < 1 << 20       # int32 arithmetic with room to spare


# -- the launch sequence and the bound -----------------------------------------------

@pytest.mark.parametrize("lanes", [0, 1, 37, x11_cuda.CHUNK - 1,
                                   x11_cuda.CHUNK, x11_cuda.CHUNK + 1,
                                   3 << 22, (3 << 22) + 77, 3 << 23,
                                   1 << 32])
def test_chunk_plan_covers_the_lanes_exactly(lanes):
    plan = x11_cuda.chunk_plan(lanes)
    assert sum(n for _, n in plan) == lanes
    at = 0
    for first, n in plan:
        assert first == at and 1 <= n <= x11_cuda.CHUNK
        at += n
    assert all(n == x11_cuda.CHUNK for _, n in plan[:-1])
    if lanes:
        assert plan[-1][1] == lanes - (len(plan) - 1) * x11_cuda.CHUNK
    # a smaller stride (a state buffer of fewer lanes) covers them too
    assert sum(n for _, n in x11_cuda.chunk_plan(min(lanes, 4096), 1000)) \
        == min(lanes, 4096)


def test_chunk_plan_refuses_what_a_launch_cannot_hold():
    for lanes in (-1, (1 << 32) + 1):
        with pytest.raises(ValueError):
            x11_cuda.chunk_plan(lanes)
    with pytest.raises(ValueError):
        x11_cuda.chunk_plan(5, 0)


def test_the_bound_takes_the_smaller_instruction_count():
    pr11 = x11_cuda.ONE_KERNEL_CHAIN
    smaller = {k: v // 2 for k, v in pr11.items()}
    larger = {k: v * 2 for k, v in pr11.items()}
    assert x11_cuda.bound_chain(smaller)[0] is smaller
    assert x11_cuda.bound_chain(larger)[0] is pr11
    ms = x11_cuda.bound_ms(1 << 22, 132, 1980.0, pr11)
    assert ms["operations"] == pytest.approx(
        (1 << 22) * (pr11["alu"] + pr11["fma"]) / 128 / (132 * 1.98e9) * 1e3)
    assert ms["operations"] == pytest.approx(14.8635, rel=1e-4)


def test_the_card_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the card-less box")
    before = (x11_cuda.search_launches.value, x11_cuda.verify_launches.value)
    for call in (lambda: x11_cuda.kernel_info("cuda"),
                 lambda: x11_cuda.stage_times("cuda", 1024),
                 lambda: x11_cuda.x11_search(bytes(76), 0, 5, [0] * 8,
                                             batch=6, k=2, device="cuda")):
        with pytest.raises(Exception):
            call()
    assert (x11_cuda.search_launches.value,
            x11_cuda.verify_launches.value) == before


@pytest.mark.parametrize("lanes", [0, 1, 1024, x11_cuda.CHUNK - 1,
                                   x11_cuda.CHUNK, 3 << 22, 3 << 23,
                                   1 << 32])
def test_the_state_holds_the_largest_chunk(lanes):
    """A call's state buffer: eight int64 words a lane of its largest
    chunk, so at most 32 MiB whatever the lanes."""
    largest = max([1] + [n for _, n in x11_cuda.chunk_plan(lanes)])
    assert x11_cuda.state_words(lanes) == 8 * largest
    assert x11_cuda.state_words(lanes) * 8 <= 32 << 20
