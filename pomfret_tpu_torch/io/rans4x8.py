"""rANS 4x8 codec (CRAM 3.0 block compression method 4).

Implements the byte-exact stream layout of the CRAM specification section 13
(the rANS_static 4x8 variant htslib links for CRAM 3.0): 12-bit normalized
frequencies, four interleaved rANS states with byte-wise renormalization at
a 2^23 lower bound, order-0 (i&3 round-robin) and order-1 (four quarters,
remainder on the 4th state, per-quarter context starting at 0).

The reference consumes this codec through htslib (`-lhts`, Makefile:11); no
htslib exists in this build, so both directions are implemented here. Encode
and decode are validated against each other plus hand-checked stream layout
tests (tests/test_cram.py).
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple

TF_SHIFT = 12
TOTFREQ = 1 << TF_SHIFT          # 4096
RANS_BYTE_L = 1 << 23


# ---------------------------------------------------------------- freqs

def _normalize_freqs(counts: Dict[int, int], total: int = TOTFREQ) -> Dict[int, int]:
    """Scale symbol counts to sum exactly `total`, every present symbol >=1."""
    n = sum(counts.values())
    if n == 0:
        return {}
    syms = sorted(counts)
    freqs = {}
    # largest remainder method with a floor of 1
    shares = {s: counts[s] * total / n for s in syms}
    for s in syms:
        freqs[s] = max(1, int(shares[s]))
    excess = sum(freqs.values()) - total
    # trim from the largest, or grow the largest, until exact
    order = sorted(syms, key=lambda s: -freqs[s])
    i = 0
    while excess > 0:
        s = order[i % len(order)]
        if freqs[s] > 1:
            freqs[s] -= 1
            excess -= 1
        i += 1
    if excess < 0:
        freqs[order[0]] += -excess
    return freqs


def _write_freqs_order0(freqs: Dict[int, int]) -> bytes:
    """Symbol-RLE + 7/15-bit frequency serialization (terminated by 0)."""
    out = bytearray()
    rle = 0
    for j in range(256):
        f = freqs.get(j, 0)
        if not f:
            continue
        if rle:
            rle -= 1
        else:
            out.append(j)
            if j and freqs.get(j - 1, 0):
                k = j + 1
                while k < 256 and freqs.get(k, 0):
                    k += 1
                rle = k - (j + 1)
                out.append(rle)
        if f < 128:
            out.append(f)
        else:
            out.append(128 | (f >> 8))
            out.append(f & 0xFF)
    out.append(0)
    return bytes(out)


def _read_freqs_order0(buf: bytes, p: int) -> Tuple[List[int], int]:
    """Returns (freq[256], new offset)."""
    freqs = [0] * 256
    rle = 0
    j = buf[p]; p += 1
    while True:
        f = buf[p]; p += 1
        if f >= 128:
            f = ((f & 127) << 8) | buf[p]; p += 1
        freqs[j] = f
        if rle:
            rle -= 1
            j += 1
        elif buf[p] == j + 1:
            j = buf[p]; p += 1
            rle = buf[p]; p += 1
        else:
            j = buf[p]; p += 1
        if j == 0:
            break
    return freqs, p


def _cum_table(freqs: List[int]):
    cum = [0] * 257
    for i in range(256):
        cum[i + 1] = cum[i] + freqs[i]
    # symbol lookup by slot
    lut = bytearray(TOTFREQ)
    for s in range(256):
        if freqs[s]:
            start, end = cum[s], cum[s + 1]
            lut[start:end] = bytes([s]) * (end - start)
    return cum, bytes(lut)


# ---------------------------------------------------------------- order 0

def _enc_put(x: int, out: bytearray, start: int, freq: int) -> int:
    x_max = ((RANS_BYTE_L >> TF_SHIFT) << 8) * freq
    while x >= x_max:
        out.append(x & 0xFF)
        x >>= 8
    return ((x // freq) << TF_SHIFT) + (x % freq) + start


def _encode_order0_payload(data: bytes) -> bytes:
    counts: Dict[int, int] = {}
    for b in data:
        counts[b] = counts.get(b, 0) + 1
    freqs = _normalize_freqs(counts)
    table = _write_freqs_order0(freqs)
    farr = [0] * 256
    for s, f in freqs.items():
        farr[s] = f
    cum, _ = _cum_table(farr)

    states = [RANS_BYTE_L] * 4
    tail = bytearray()  # bytes emitted in reverse order
    for i in range(len(data) - 1, -1, -1):
        c = data[i]
        states[i & 3] = _enc_put(states[i & 3], tail, cum[c], farr[c])
    head = b"".join(struct.pack("<I", states[k]) for k in range(4))
    return table + head + bytes(reversed(tail))


def _decode_order0_payload(buf: bytes, p: int, out_size: int) -> bytes:
    freqs, p = _read_freqs_order0(buf, p)
    cum, lut = _cum_table(freqs)
    states = list(struct.unpack_from("<4I", buf, p))
    p += 16
    out = bytearray(out_size)
    n = len(buf)
    for i in range(out_size):
        k = i & 3
        x = states[k]
        f = x & (TOTFREQ - 1)
        s = lut[f]
        out[i] = s
        x = freqs[s] * (x >> TF_SHIFT) + f - cum[s]
        while x < RANS_BYTE_L and p < n:
            x = (x << 8) | buf[p]
            p += 1
        states[k] = x
    return bytes(out)


# ---------------------------------------------------------------- order 1

def _encode_order1_payload(data: bytes) -> bytes:
    n = len(data)
    isz4 = n >> 2
    # transition counts per (ctx, sym); each quarter starts at ctx 0
    counts: Dict[int, Dict[int, int]] = {}

    def bump(ctx, sym):
        row = counts.setdefault(ctx, {})
        row[sym] = row.get(sym, 0) + 1

    starts = [0, isz4, 2 * isz4, 3 * isz4]
    ends = [isz4, 2 * isz4, 3 * isz4, n]
    for k in range(4):
        ctx = 0
        for i in range(starts[k], ends[k]):
            bump(ctx, data[i])
            ctx = data[i]

    freqs: Dict[int, Dict[int, int]] = {c: _normalize_freqs(r) for c, r in counts.items()}
    farr: Dict[int, List[int]] = {}
    cums: Dict[int, List[int]] = {}
    for c, row in freqs.items():
        fa = [0] * 256
        for s, f in row.items():
            fa[s] = f
        cum = [0] * 257
        for i in range(256):
            cum[i + 1] = cum[i] + fa[i]
        farr[c] = fa
        cums[c] = cum

    # context table serialization: RLE over present contexts, inner order-0
    table = bytearray()
    rle = 0
    for c in range(256):
        if c not in freqs:
            continue
        if rle:
            rle -= 1
        else:
            table.append(c)
            if c and (c - 1) in freqs:
                k = c + 1
                while k < 256 and k in freqs:
                    k += 1
                rle = k - (c + 1)
                table.append(rle)
        table += _write_freqs_order0(freqs[c])
    table.append(0)

    # encode quarters in reverse, state k owns quarter k; remainder on state 3
    states = [RANS_BYTE_L] * 4
    tail = bytearray()
    pos = [ends[k] - 1 for k in range(4)]
    # interleave: emit symbols round-robin from the back so the decoder's
    # round-robin front-to-back renormalization reads bytes in order
    remaining = [pos[k] - starts[k] + 1 for k in range(4)]
    # the remainder of quarter 3 beyond isz4 symbols is flushed first
    while remaining[3] > remaining[0]:
        i = pos[3]
        ctx = data[i - 1] if i - 1 >= starts[3] else 0
        c = data[i]
        states[3] = _enc_put(states[3], tail, cums[ctx][c], farr[ctx][c])
        pos[3] -= 1
        remaining[3] -= 1
    for _ in range(remaining[0]):
        for k in (3, 2, 1, 0):
            i = pos[k]
            ctx = data[i - 1] if i - 1 >= starts[k] else 0
            c = data[i]
            states[k] = _enc_put(states[k], tail, cums[ctx][c], farr[ctx][c])
            pos[k] -= 1
    head = b"".join(struct.pack("<I", states[k]) for k in range(4))
    return bytes(table) + head + bytes(reversed(tail))


def _decode_order1_payload(buf: bytes, p: int, out_size: int) -> bytes:
    # context table
    freqs: Dict[int, List[int]] = {}
    cums: Dict[int, List[int]] = {}
    luts: Dict[int, bytes] = {}
    rle = 0
    c = buf[p]; p += 1
    while True:
        fr, p = _read_freqs_order0(buf, p)
        cum, lut = _cum_table(fr)
        freqs[c] = fr
        cums[c] = cum
        luts[c] = lut
        if rle:
            rle -= 1
            c += 1
        elif buf[p] == c + 1:
            c = buf[p]; p += 1
            rle = buf[p]; p += 1
        else:
            c = buf[p]; p += 1
        if c == 0:
            break
    states = list(struct.unpack_from("<4I", buf, p))
    p += 16
    n = len(buf)
    out = bytearray(out_size)
    isz4 = out_size >> 2
    ptr = [0, isz4, 2 * isz4, 3 * isz4]
    ctx = [0, 0, 0, 0]

    def step(k):
        nonlocal p
        x = states[k]
        f = x & (TOTFREQ - 1)
        s = luts[ctx[k]][f]
        row = freqs[ctx[k]]
        x = row[s] * (x >> TF_SHIFT) + f - cums[ctx[k]][s]
        while x < RANS_BYTE_L and p < n:
            x = (x << 8) | buf[p]
            p += 1
        states[k] = x
        out[ptr[k]] = s
        ptr[k] += 1
        ctx[k] = s

    for _ in range(isz4):
        for k in range(4):
            step(k)
    while ptr[3] < out_size:
        step(3)
    return bytes(out)


# ---------------------------------------------------------------- public

def compress(data: bytes, order: int = 0) -> bytes:
    """Full rans4x8 stream: order byte, compressed size u32, raw size u32,
    then the frequency table + states + byte stream."""
    if order not in (0, 1):
        raise ValueError("order must be 0 or 1")
    if len(data) == 0:
        payload = b""
        order = 0
    elif order == 0 or len(data) < 4:
        order = 0
        payload = _encode_order0_payload(data)
    else:
        payload = _encode_order1_payload(data)
    return struct.pack("<BII", order, len(payload), len(data)) + payload


def uncompress(stream: bytes) -> bytes:
    order, comp_size, raw_size = struct.unpack_from("<BII", stream, 0)
    if raw_size == 0:
        return b""
    if order in (0, 1):
        try:
            from . import native
            out = native.rans4x8_uncompress(stream, raw_size)
            if out is not None:
                return out
        except ImportError:
            pass
        if order == 0:
            return _decode_order0_payload(stream, 9, raw_size)
        return _decode_order1_payload(stream, 9, raw_size)
    raise ValueError(f"unknown rans4x8 order {order}")
