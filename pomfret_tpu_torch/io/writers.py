"""Output writers: GTF/TSV phase blocks, VCF rewrite (byte surgery), BAM
re-tagging. Mirrors blockjoin.c:2365-3103."""
from __future__ import annotations

from ..core.intervals import (FlipLookup, Storage, UnphasedLookup,
                              check_if_in_dropped_intervals,
                              get_flip_status_by_idx, get_new_phaseblock_id)
from ..core.variants import HAPTAG_UNPHASED
from ..utils.log import log_err, log_info
from .bam import BamReader
from .bam_writer import BamWriter
from .textio import iter_lines


def output_tsv(st: Storage, prefix: str) -> None:
    # blockjoin.c:2695-2719
    n_blocks = 0
    with open(prefix + ".mp.tsv", "w") as f:
        for name, rr in zip(st.ref_names, st.ranges):
            for s, e in rr.phaseblocks:
                f.write(f"{name}\t{s}\t{e}\n")
                n_blocks += 1
    log_info("output_tsv", f"wrote tsv ({len(st.ref_names)} refs, total {n_blocks} blocks)")


def output_gtf(st: Storage, prefix: str) -> None:
    # blockjoin.c:2721-2755; skips placeholder blocks with 0 coords
    n_blocks = 0
    with open(prefix + ".mp.gtf", "w") as f:
        for name, rr in zip(st.ref_names, st.ranges):
            for s, e in rr.phaseblocks:
                if s == 0 or e == 0:
                    continue
                f.write(f'{name}\tPhasing\texon\t{s}\t{e}\t.\t+\t.\t'
                        f'gene_id "{s}"; transcript_id "{s}.1"\n')
                n_blocks += 1
    log_info("output_gtf", f"wrote gtf ({len(st.ref_names)} refs, total {n_blocks} blocks)")


class _VcfRewriteState:
    def __init__(self):
        self.prev_pos = -1
        self.flip = FlipLookup()


def alter_vcf_line(line: str, st: Storage, state: _VcfRewriteState) -> (int, str):
    """Returns (status, new_line): status 0 unchanged / 1 modified /
    2 dropped-PS rewrite. Faithful to alter_vcf_line (blockjoin.c:2758-2908),
    including the absolute-offset GT surgery applied to the spliced line."""
    if line.startswith("#"):
        if not line.startswith("##"):
            n = line.count("\t") + 1
            if n < 10:
                log_err("alter_vcf_line", f"vcf only has {n} columns; mandatory >=8; we also need FORMAT and at least 1 sample")
                raise SystemExit(1)
            if n > 10:
                log_err("alter_vcf_line", "multi-sample vcf not implemented, TODO/TBD")
                raise SystemExit(1)
        return 0, line

    # column scan, tracking absolute offsets
    col = 0
    start = 0
    pos = 0
    i_ps = -1
    i_gt = -1
    i_ref = -1
    s_l = len(line)
    sample_start = 0
    for i in range(s_l + 1):
        if i < s_l and line[i] != "\t":
            continue
        tok = line[start:i]
        if col == 0:
            i_ref = st.ref_index(tok)
            pos = 0
            i_ps = -1
            i_gt = -1
            if i_ref < 0:
                break
        elif col == 1:
            pos = int(tok)
            if pos < state.prev_pos:  # new chromosome in a sorted VCF
                state.flip.reset()
            state.prev_pos = pos
        elif col == 8:
            fmt = tok.split(":")
            i_ps = fmt.index("PS") if "PS" in fmt else -1
            i_gt = fmt.index("GT") if "GT" in fmt else -1
        elif col == 9:
            sample_start = start
        col += 1
        start = i + 1
        if col == 10:
            break
    if pos == 0 or i_ps < 0 or i_ref < 0:
        return 0, line

    sample = line[sample_start:]
    fields = sample.split(":")
    if i_ps >= len(fields) or (i_gt >= 0 and i_gt >= len(fields)):
        log_err("alter_vcf_line", f"saw PS or GT tag but value not found? pos={pos}")
        return 0, line
    ps_start = sum(len(f) + 1 for f in fields[:i_ps])
    ps_l = len(fields[i_ps])
    gt_start = sum(len(f) + 1 for f in fields[:i_gt]) if i_gt >= 0 else -1
    gt_l = len(fields[i_gt]) if i_gt >= 0 else 0
    if ps_l == 1 and fields[i_ps] == ".":
        return 0, line
    gt = fields[i_gt] if i_gt >= 0 else ""
    if len(gt) < 3 or gt[1] != "|":
        return 0, line
    if gt[0] not in "01" or gt[2] not in "01":
        return 0, line

    rr = st.ranges[i_ref]
    group_id = get_new_phaseblock_id(rr, pos)
    is_dropped = check_if_in_dropped_intervals(rr, pos)
    need_flip = state.flip.get(rr, pos)

    is_middle_var = False
    if group_id >= 0 and is_dropped and st.varphase_in_dropped is not None:
        hap_of_ref = st.varphase_in_dropped[i_ref].get(pos - 1)
        if hap_of_ref in (0, 1):
            is_middle_var = True

    abs_ps = sample_start + ps_start
    abs_gt = sample_start + gt_start
    if group_id < 0 or is_dropped:
        if not is_middle_var:
            return 0, line
        new = line[:abs_ps] + "." + line[abs_ps + ps_l:]
        # wipe genotype phasing at the ORIGINAL absolute offset (quirk)
        lst = list(new)
        lst[abs_gt + 1] = "/"
        return 2, "".join(lst)
    new = line[:abs_ps] + str(group_id) + line[abs_ps + ps_l:]
    if need_flip:
        lst = list(new)
        lst[abs_gt] = "1" if lst[abs_gt] == "0" else "0"
        lst[abs_gt + 2] = "1" if lst[abs_gt] == "0" else "0"
        new = "".join(lst)
    return 1, new


def output_modify_vcf(fn_vcf: str, st: Storage, prefix: str) -> None:
    # blockjoin.c:2909-2988
    state = _VcfRewriteState()
    n_modified = 0
    n_failed = 0
    n_tot = 0
    with open(prefix + ".mp.vcf", "w") as out:
        for line in iter_lines(fn_vcf):
            stat, new = alter_vcf_line(line, st, state)
            n_tot += 1
            if stat == 0:
                out.write(line + "\n")
            else:
                if stat == 2:
                    n_failed += 1
                else:
                    n_modified += 1
                out.write(new + "\n")
    log_info("output_modify_vcf",
             f"wrote vcf output, ({n_modified} ok + {n_failed} dropped)/{n_tot} lines modified")


def get_read_new_haplotag(qname: str, hp_raw: int, st: Storage, need_flip: int) -> int:
    # blockjoin.c:2990-3020
    hp = st.qname2haptag.get(qname)
    if hp is None:
        hp = hp_raw
        if hp not in (0, 1):
            return hp
    if need_flip:
        hp ^= 1
    return hp


def _iter_inflated_native(path: str, threads: int, comp_chunk: int = 8 << 20):
    """Yield uncompressed BGZF payload chunks using the native inflate pool
    (streaming: compressed slices in, whole complete-block prefixes out)."""
    import struct
    from . import native
    from .bgzf import _parse_block_header
    from ..utils.log import log_warn
    with open(path, "rb") as f:
        rem = b""
        stop = False
        while True:
            data = f.read(comp_chunk)
            buf = rem + data
            if not buf:
                break
            # largest prefix of COMPLETE blocks (headers are ~one per 64KB:
            # trivial Python cost). Guard the FULL header extent (xlen may
            # exceed the standard 6) before parsing, and treat non-gzip
            # trailing bytes like the block-structured readers do: stop at
            # them with a warning instead of failing the whole rewrite.
            off = 0
            while off + 12 <= len(buf):
                if buf[off] != 0x1F or buf[off + 1] != 0x8B:
                    log_warn("stream_retag_native",
                             f"ignoring {len(buf) - off} trailing bytes "
                             "after the last BGZF block")
                    stop = True
                    break
                (xlen,) = struct.unpack_from("<H", buf, off + 10)
                if off + 12 + xlen > len(buf):
                    break
                _, bsize = _parse_block_header(buf, off)
                if off + bsize > len(buf):
                    break
                off += bsize

            def _tail_is_junk(tail: bytes) -> bool:
                # warn-and-stop parity with the block-structured readers: a
                # sub-header tail that is not a gzip-magic prefix is trailing
                # junk, not a truncated block — only a tail that parsed (or
                # could parse) as a block header raises.
                if len(tail) >= 2:
                    return tail[0] != 0x1F or tail[1] != 0x8B
                return len(tail) == 1 and tail[0] != 0x1F

            if off == 0:
                if stop:
                    break  # junk directly at a block boundary: already warned
                if not data:  # EOF with an unparseable sub-header tail
                    if _tail_is_junk(buf):
                        log_warn("stream_retag_native",
                                 f"ignoring {len(buf)} trailing bytes "
                                 "after the last BGZF block")
                        break
                    raise ValueError("truncated BGZF tail")
                rem = buf
                continue
            out = native.bgzf_inflate_all(buf[:off], n_threads=threads)
            if out is None:
                raise RuntimeError("native inflate failed mid-stream")
            rem = buf[off:]
            yield out
            if stop:
                break
            if not data:
                if rem:
                    if _tail_is_junk(rem):
                        log_warn("stream_retag_native",
                                 f"ignoring {len(rem)} trailing bytes "
                                 "after the last BGZF block")
                        break
                    raise ValueError("truncated BGZF tail")
                break


def stream_retag_native(fn_bam: str, fn_out: str, build_maps, st=None,
                        mode: int = 0, threads: int = 1, tsv=None,
                        write_bam: bool = True) -> bool:
    """Native whole-BAM HP retag (bam_retag_hp in pomfret_native.cpp):
    streams compressed slices through the native inflate pool, patches
    records in bulk in one C++ pass, and bulk-writes the result — the
    per-record Python loop costs ~220 us per 20kb nanopore record (full
    decode + re-encode), tens of minutes at WGS scale. Returns False when
    inapplicable (CRAM input, lib unavailable, POMFRET_NO_NATIVE_RETAG=1):
    callers fall back to their Python loops, which stay byte-identical
    (tests/test_native_retag.py).

    build_maps() -> the qmap triple for bam_retag_hp (deferred so callers
    skip the work when this returns False early). mode 0 = methphase
    rewrite with st's flip machinery; mode 1 = varhaptag (tsv gets
    '{qname}\\t{raw+1}\\t{new+1}' lines)."""
    import os
    import struct
    import numpy as np
    from . import native
    from .bgzf import is_bgzf
    if os.environ.get("POMFRET_NO_NATIVE_RETAG") or not native.native_available():
        return False
    from .cram import is_cram, spool_path
    if is_cram(fn_bam):
        # CRAM input rides the one-time BAM spool (io/cram.py spool_path):
        # the native retag pass then streams at BAM speed; the record bytes
        # are exactly what the Python CramReader loop would re-encode
        if os.environ.get("POMFRET_NO_CRAM_SPOOL"):
            return False
        fn_bam = spool_path(fn_bam)
    if not is_bgzf(fn_bam):
        return False

    chunks = _iter_inflated_native(fn_bam, max(4, threads))
    buf = b""
    bpos = 0   # cursor: take() must not re-slice multi-MB chunks per field

    def take(n: int) -> bytes:
        nonlocal buf, bpos
        while len(buf) - bpos < n:
            try:
                buf += next(chunks)
            except StopIteration:
                raise ValueError("truncated BAM header") from None
        out = buf[bpos : bpos + n]
        bpos += n
        return out

    if take(4) != b"BAM\x01":
        return False  # foreign container: Python path handles it
    (l_text,) = struct.unpack("<i", take(4))
    header_text = take(l_text).decode(errors="replace")
    (n_ref,) = struct.unpack("<i", take(4))
    ref_names, ref_lens = [], []
    for _ in range(n_ref):
        (ln,) = struct.unpack("<i", take(4))
        ref_names.append(take(ln)[:-1].decode())
        (rl,) = struct.unpack("<i", take(4))
        ref_lens.append(rl)

    maps = build_maps()
    iv_off = np.zeros(n_ref + 1, dtype=np.int64)
    fl_off = np.zeros(n_ref + 1, dtype=np.int64)
    starts, ends, flips = [], [], []
    if mode == 0:
        for r, name in enumerate(ref_names):
            i_ref = st.ref_index(name)
            if i_ref >= 0:
                rr = st.ranges[i_ref]
                starts.extend(rr.starts)
                ends.extend(rr.ends)
                flips.extend(rr.flips_onraw)
            iv_off[r + 1] = len(starts)
            fl_off[r + 1] = len(flips)
    intervals = (iv_off, fl_off,
                 np.asarray(starts, dtype=np.int64),
                 np.asarray(ends, dtype=np.int64),
                 np.asarray(flips, dtype=np.int32), n_ref)

    w = None
    if write_bam:
        w = BamWriter(fn_out, ref_names, ref_lens, header_text=header_text,
                      threads=threads, keep_index_info=True)
    state = np.array([0, 0, 1], dtype=np.int32)
    buf = buf[bpos:]   # header consumed; record stream follows
    exhausted = False
    try:
        while True:
            while not exhausted and len(buf) < (8 << 20):
                try:
                    buf += next(chunks)
                except StopIteration:
                    exhausted = True
            if not buf:
                break
            out, metas, consumed = native.bam_retag_hp(buf, maps, intervals,
                                                       state, mode)
            if consumed == 0:
                if exhausted:
                    raise ValueError(f"truncated BAM record tail ({len(buf)}B)")
                try:  # a single record larger than the refill mark: keep growing
                    buf += next(chunks)
                except StopIteration:
                    exhausted = True
                continue
            if w is not None:
                w.write_raw_records(out, metas[:, :6])
            if tsv is not None:
                lines = []
                for k in range(len(metas)):
                    o = int(metas[k, 3])
                    ln = out[o + 12]
                    qn = out[o + 36 : o + 36 + ln - 1].decode()
                    lines.append(
                        f"{qn}\t{int(metas[k, 6]) + 1}\t{int(metas[k, 7]) + 1}\n")
                tsv.write("".join(lines))
            buf = buf[consumed:]
            if exhausted and not buf:
                break
        if w is not None:
            w.close()
            w.build_index(fn_out + ".bai", n_ref=n_ref)
    except BaseException:
        # a mid-stream failure must not leave a truncated destination file
        # (no EOF block, no .bai) that downstream tooling could mistake for
        # output: close and remove the partial artifacts, then re-raise
        if w is not None:
            try:
                w.close()
            except Exception:
                pass
            for p in (fn_out, fn_out + ".bai"):
                try:
                    os.remove(p)
                except OSError:
                    pass
        raise
    return True


def _retag_native(fn_bam: str, st: Storage, fn_out: str, threads: int) -> bool:
    from . import native

    def build_maps():
        return (native.qmap_arrays(st.qname2haptag),
                native.qmap_arrays(
                    st.qname2haptag_raw if st.stores_raw_tag else {}),
                st.stores_raw_tag)

    return stream_retag_native(fn_bam, fn_out, build_maps, st=st, mode=0,
                               threads=threads)


def output_modify_bam(fn_bam: str, st: Storage, fn_out: str, threads: int = 1) -> None:
    # blockjoin.c:3022-3103; input may be BAM or CRAM, output is BAM ("wb",
    # matching the reference)
    from .cram import open_alignment
    if _retag_native(fn_bam, st, fn_out, threads):
        return
    rd = open_alignment(fn_bam, threads=threads)
    w = BamWriter(fn_out, rd.ref_names, rd.ref_lens,
                  header_text=rd.header_text, threads=threads,
                  keep_index_info=True)
    prev_tid = 0
    need_flip = 0
    unph = UnphasedLookup()
    for rec in rd.fetch_all():
        if rec.refID < 0:
            w.write(rec)  # reference would crash here; pass through instead
            continue
        if rec.refID != prev_tid:
            unph.reset()
            # NOTE: the reference does NOT reset need_flip on chromosome
            # change (blockjoin.c:3057-3062) — it persists until the next
            # lookup update. Quirk preserved.
            prev_tid = rec.refID
        refname = rd.ref_names[rec.refID]
        i_ref = st.ref_index(refname)
        if st.stores_raw_tag:
            hp_raw = st.qname2haptag_raw.get(rec.qname, HAPTAG_UNPHASED)
        else:
            hp = rec.get_tag("HP")
            hp_raw = HAPTAG_UNPHASED if hp is None or hp == 0 else hp - 1
        if i_ref >= 0:
            rr = st.ranges[i_ref]
            _, updated = unph.check(rr, rec.pos)
            if updated:
                flip = get_flip_status_by_idx(rr, unph.prev_idx - 1)
                assert flip >= 0
                need_flip = flip
        hp = get_read_new_haplotag(rec.qname, hp_raw, st, need_flip)
        rec.set_int_tag("HP", hp + 1)
        w.write(rec)
    w.close()
    w.build_index(fn_out + ".bai", n_ref=len(rd.ref_names))
