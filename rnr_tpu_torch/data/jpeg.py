"""JPEG decoding in numpy, bit-equal to libjpeg-turbo's default decode
(what cv2.imread and PIL call).

Huffman-coded 8-bit frames: baseline and extended sequential (SOF0,
SOF1) and progressive (SOF2, spectral selection and successive
approximation, DC and AC first and refine scans); restart intervals;
gray or three components, sampled 4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1 or
any other integral ratio; any width and height.  The decode follows
libjpeg-turbo's default path step by step:

- the entropy decoding, the one part that loops in Python per symbol:
  every scan's bits are unstuffed once and peeked 16 at a time at every
  bit position (`_peek16`), so the loop only chains table lookups and
  records where each symbol starts; the values are read from those
  positions afterwards, for all symbols at once;
- `jidctint.c`'s islow integer IDCT with its wrapping range limit, over
  all blocks at once;
- `jdsample.c`'s upsampling: the "fancy" triangle filters for h2v1,
  h1v2 and h2v2 with their alternating rounding biases (h2v1 and h2v2
  replicate where the downsampled width is 2 or less), replication for
  every other ratio;
- `jdcolor.c`'s fixed-point YCbCr -> RGB tables; no colour transform for
  an Adobe APP14 `transform=0` file or R, G, B component ids; the JFIF,
  Adobe and component-id rules of `jdapimin.c` for which applies.

Arithmetic coding, lossless and hierarchical frames, 12-bit samples,
CMYK / YCCK, fractional sampling ratios and a progressive file whose
refinement stops short (libjpeg-turbo smooths such blocks) raise a
ValueError naming the feature.  The EXIF orientation tag (APP1, 0x0112)
is parsed and returned beside the pixels.
"""

from __future__ import annotations

import struct

import numpy as np

# zigzag index k -> natural (row-major) index, jpeg_natural_order
NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# natural index -> zigzag index
ZIGZAG = np.argsort(NATURAL)

REFUSED_SOF = {0xC3: "lossless coding (SOF3)",
               **{m: f"hierarchical coding (SOF{m - 0xC0})"
                  for m in (0xC5, 0xC6, 0xC7)},
               0xDE: "hierarchical coding (DHP)",
               0xDF: "hierarchical coding (EXP)",
               **{m: f"arithmetic coding (SOF{m - 0xC0})"
                  for m in (0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF)},
               0xCC: "arithmetic coding (DAC)"}


def _refuse(what: str):
    raise ValueError(f"JPEG: {what} is not decoded by the port, which "
                   "decodes Huffman-coded 8-bit baseline, extended and "
                   "progressive gray or YCbCr / RGB files")


# ---------------------------------------------------------------- Huffman


class _Table:
    """A Huffman table as 16-bit lookups: code length and symbol for
    every 16-bit window (length 0: no code starts with those bits)."""

    def __init__(self, counts: bytes, symbols: bytes):
        self.length = np.zeros(1 << 16, np.int64)
        self.symbol = np.zeros(1 << 16, np.int64)
        code, k = 0, 0
        for n_bits in range(1, 17):
            for _ in range(counts[n_bits - 1]):
                lo = code << (16 - n_bits)
                hi = (code + 1) << (16 - n_bits)
                if hi > 1 << 16:
                    raise ValueError("JPEG: bad Huffman table")
                self.length[lo:hi] = n_bits
                self.symbol[lo:hi] = symbols[k]
                code += 1
                k += 1
            code <<= 1
        self._lists = {}

    def lists(self, kind: str):
        """Python lists for the entropy loop, by 16-bit window: "dc" the
        bits a DC symbol takes with its value; "ac" the bits an AC
        symbol takes with its value and how far it moves k (the run
        plus one, 16 for ZRL, 64 for EOB); "sym" code length, run and
        size.  A window with no code moves by 16 bits and ends the
        block, for the check after the loop to refuse."""
        if kind not in self._lists:
            bad = self.length == 0
            size = self.symbol & 15
            run = self.symbol >> 4
            if kind == "dc":
                out = (np.where(bad, 16, self.length + self.symbol),)
            elif kind == "ac":
                kinc = np.where(size > 0, run + 1,
                                np.where(run == 15, 16, 64))
                out = (np.where(bad, 16, self.length + size),
                       np.where(bad, 64, kinc))
            else:
                out = (np.where(bad, 16, self.length), run, size)
            self._lists[kind] = tuple(a.tolist() for a in out)
        return self._lists[kind]


def _extend(bits: np.ndarray, size: np.ndarray) -> np.ndarray:
    """HUFF_EXTEND: `size` bits read as a signed magnitude category."""
    half = np.where(size > 0, 1 << np.maximum(size - 1, 0), 0)
    return np.where(bits < half, bits - (1 << size) + 1, bits)


def _bits(pk: np.ndarray, pos: np.ndarray, n: np.ndarray) -> np.ndarray:
    """The n (0..16) bits at each bit position, as unsigned ints."""
    return pk[pos].astype(np.int64) >> (16 - n)


# ------------------------------------------------------------ scan bytes


def _scan_bytes(arr: np.ndarray, start: int):
    """The entropy-coded data from `start` to the next marker that is not
    RSTn: its bytes unstuffed, the byte offset where each restart
    interval starts in them, and the offset of the marker that ends
    it."""
    ff = np.flatnonzero(arr[start:-1] == 0xFF) + start
    nxt = arr[ff + 1]
    marker = (nxt != 0) & (nxt != 0xFF) & ((nxt < 0xD0) | (nxt > 0xD7))
    ends = ff[marker]
    end = int(ends[0]) if ends.size else arr.size
    inside = ff < end
    ff, nxt = ff[inside], nxt[inside]
    keep = np.ones(end - start, bool)
    keep[ff[nxt == 0] + 1 - start] = False       # stuffed 0x00
    keep[ff[nxt == 0xFF] - start] = False        # fill bytes
    rst = ff[(nxt >= 0xD0) & (nxt <= 0xD7)] - start
    keep[rst] = False
    keep[rst + 1] = False
    before = np.concatenate([[0], np.cumsum(keep)])
    seg = np.concatenate([[0], before[rst]]).astype(np.int64)
    return arr[start:end][keep], seg, end


def _peek16(data: np.ndarray) -> np.ndarray:
    """uint16 [8 * len + 64]: the 16 bits starting at every bit position
    (zero bits past the end)."""
    b = np.concatenate([data, np.zeros(10, np.uint8)]).astype(np.uint32)
    w = (b[:-2] << 16) | (b[1:-1] << 8) | b[2:]
    shift = np.arange(8, 0, -1, dtype=np.uint32)
    return ((w[:, None] >> shift) & 0xFFFF).astype(np.uint16).reshape(-1)


# ------------------------------------------------------------------ frame


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.qt = None          # latched at the first scan that codes it


class _Frame:
    def __init__(self, body: bytes, marker: int):
        prec, self.height, self.width, n = struct.unpack(">BHHB", body[:6])
        if prec != 8:
            _refuse(f"{prec}-bit precision")
        if self.height == 0 or self.width == 0:
            _refuse("a frame of height 0 (DNL)")
        if n not in (1, 3):
            _refuse("CMYK / YCCK (4 components)" if n == 4
                    else f"a {n}-component frame")
        self.progressive = marker == 0xC2
        self.comps = []
        for i in range(n):
            cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
            if not (1 <= hv >> 4 <= 4 and 1 <= hv & 15 <= 4):
                raise ValueError(f"JPEG: sampling factors {hv:#x}")
            self.comps.append(_Component(cid, hv >> 4, hv & 15, tq))
        self.hmax = max(c.h for c in self.comps)
        self.vmax = max(c.v for c in self.comps)
        self.mcux = -(-self.width // (8 * self.hmax))
        self.mcuy = -(-self.height // (8 * self.vmax))
        for c in self.comps:
            if self.hmax % c.h or self.vmax % c.v:
                _refuse(f"fractional sampling ({c.h}x{c.v} of "
                        f"{self.hmax}x{self.vmax})")
            c.bw, c.bh = self.mcux * c.h, self.mcuy * c.v   # allocated
            c.wib = -(-self.width * c.h // (8 * self.hmax))
            c.hib = -(-self.height * c.v // (8 * self.vmax))
            c.dw = -(-self.width * c.h // self.hmax)
            c.dh = -(-self.height * c.v // self.vmax)
            c.coef = np.zeros((c.bh * c.bw, 64), np.int64)   # zigzag order
            c.bits = np.full(64, -1)     # coef_bits: each k's last Al


def _scan_blocks(frame: _Frame, comps: list):
    """The blocks of a scan in coding order: (component index in the
    scan, flat block index) per block, and blocks per MCU."""
    if len(comps) == 1:
        c = comps[0]
        by, bx = np.mgrid[0:c.hib, 0:c.wib]
        return (np.zeros(by.size, np.int64),
                (by * c.bw + bx).reshape(-1), 1)
    ci, blk = [], []
    my, mx = np.mgrid[0:frame.mcuy, 0:frame.mcux]
    for i, c in enumerate(comps):
        for v in range(c.v):
            for h in range(c.h):
                ci.append(np.full(my.size, i))
                blk.append(((my * c.v + v) * c.bw + mx * c.h + h).reshape(-1))
    per_mcu = len(ci)
    return (np.stack(ci, 1).reshape(-1), np.stack(blk, 1).reshape(-1),
            per_mcu)


def _segmented_cumsum(x: np.ndarray, group: np.ndarray) -> np.ndarray:
    """Inclusive running sum of x, restarting where `group` changes."""
    cs = np.cumsum(x)
    first = np.flatnonzero(np.concatenate([[True], group[1:] != group[:-1]]))
    base = np.repeat(cs[first] - x[first],
                     np.diff(np.concatenate([first, [x.size]])))
    return cs - base


# ------------------------------------------------------------------ scans


class _Scan:
    """One scan's tables, bits and restart layout."""

    def __init__(self, frame, body, dc_tabs, ac_tabs, restart, arr, start):
        n = body[0]
        ids = [c.id for c in frame.comps]
        self.comps, self.dc, self.ac = [], [], []
        for i in range(n):
            cid, t = body[1 + 2 * i], body[2 + 2 * i]
            if cid not in ids:
                raise ValueError(f"JPEG: scan codes unknown component {cid}")
            self.comps.append(frame.comps[ids.index(cid)])
            self.dc.append(dc_tabs.get(t >> 4))
            self.ac.append(ac_tabs.get(t & 15))
        self.ss, self.se, a = body[1 + 2 * n:4 + 2 * n]
        self.ah, self.al = a >> 4, a & 15
        data, seg, self.end = _scan_bytes(arr, start)
        self.pk = _peek16(data)
        self.seg_bits = (seg * 8).tolist()
        self.ci, self.blk, self.per_mcu = _scan_blocks(frame, self.comps)
        self.restart = restart

    def table(self, tabs, i):
        if tabs[i] is None:
            raise ValueError("JPEG: scan uses an undefined Huffman table")
        return tabs[i]

    def interval_of_block(self) -> np.ndarray:
        mcu = np.arange(self.blk.size) // self.per_mcu
        return mcu // self.restart if self.restart else np.zeros_like(mcu)

    def check_codes(self, tabs, pos, ci):
        ln = np.stack([t.length for t in tabs])[ci, self.pk[pos]]
        if (ln == 0).any():
            raise ValueError("JPEG: corrupt data (bad Huffman code)")
        return ln

    def dc_values(self, dc_pos: np.ndarray) -> np.ndarray:
        """The DC differences at the recorded positions, summed into DC
        values per component (the predictor reset at every restart)."""
        tabs = [self.table(self.dc, i) for i in range(len(self.comps))]
        ln = self.check_codes(tabs, dc_pos, self.ci)
        size = np.stack([t.symbol for t in tabs])[self.ci, self.pk[dc_pos]]
        diff = _extend(_bits(self.pk, dc_pos + ln, size), size)
        interval = self.interval_of_block()
        out = np.empty_like(diff)
        for i in range(len(self.comps)):
            sel = self.ci == i
            out[sel] = _segmented_cumsum(diff[sel], interval[sel])
        return out


def _store(c: _Component, blk, k, val):
    c.coef[blk, k] = val.astype(np.int16)        # JCOEF


def _sequential(scan: _Scan) -> None:
    """A baseline / extended scan: every block's DC and AC symbols."""
    dcs = [scan.table(scan.dc, i).lists("dc")[0]
           for i in range(len(scan.comps))]
    acs = [scan.table(scan.ac, i).lists("ac") for i in range(len(scan.comps))]
    unit = [(dcs[i], acs[i][0], acs[i][1])
            for i in scan.ci[:scan.per_mcu].tolist()]
    pk, seg_bits, ri = memoryview(scan.pk), scan.seg_bits, scan.restart
    n_mcu = scan.blk.size // scan.per_mcu
    dc_pos, ac_pos, ac_end = [], [], []
    dc_add, ac_add, end_add = dc_pos.append, ac_pos.append, ac_end.append
    pos = seg_bits[0]
    try:
        for m in range(n_mcu):
            if ri and m and m % ri == 0:
                pos = seg_bits[m // ri]
            for dca, aca, aki in unit:
                dc_add(pos)
                pos += dca[pk[pos]]
                k = 1
                while k < 64:
                    v = pk[pos]
                    ac_add(pos)
                    pos += aca[v]
                    k += aki[v]
                end_add(len(ac_pos))
    except IndexError:
        raise ValueError("JPEG: truncated scan data") from None
    dc = scan.dc_values(np.asarray(dc_pos, np.int64))
    for i, c in enumerate(scan.comps):
        sel = scan.ci == i
        _store(c, scan.blk[sel], 0, dc[sel])
    pos = np.asarray(ac_pos, np.int64)
    counts = np.diff(np.concatenate([[0], ac_end]))
    block = np.repeat(np.arange(counts.size), counts)
    ci = scan.ci[block]
    tabs = [scan.table(scan.ac, i) for i in range(len(scan.comps))]
    ln = scan.check_codes(tabs, pos, ci)
    sym = np.stack([t.symbol for t in tabs])[ci, scan.pk[pos]]
    run, size = sym >> 4, sym & 15
    kinc = np.where(size > 0, run + 1, np.where(run == 15, 16, 64))
    k = 1 + _segmented_cumsum(kinc, block) - kinc + run
    val = _extend(_bits(scan.pk, pos + ln, size), size)
    coded = size > 0
    k = np.minimum(k, 63)       # jpeg_natural_order's padding entries
    for i, c in enumerate(scan.comps):
        sel = coded & (ci == i)
        _store(c, scan.blk[block[sel]], k[sel], val[sel])


def _dc_first(scan: _Scan) -> None:
    dcs = [scan.table(scan.dc, i).lists("dc")[0]
           for i in range(len(scan.comps))]
    unit = [dcs[i] for i in scan.ci[:scan.per_mcu].tolist()]
    pk, seg_bits, ri = memoryview(scan.pk), scan.seg_bits, scan.restart
    dc_pos = []
    add = dc_pos.append
    pos = seg_bits[0]
    try:
        for m in range(scan.blk.size // scan.per_mcu):
            if ri and m and m % ri == 0:
                pos = seg_bits[m // ri]
            for dca in unit:
                add(pos)
                pos += dca[pk[pos]]
    except IndexError:
        raise ValueError("JPEG: truncated scan data") from None
    dc = scan.dc_values(np.asarray(dc_pos, np.int64))
    for i, c in enumerate(scan.comps):
        sel = scan.ci == i
        _store(c, scan.blk[sel], 0, dc[sel] << scan.al)


def _dc_refine(scan: _Scan) -> None:
    """One bit per block, in order within each restart interval."""
    interval = scan.interval_of_block()
    first = np.searchsorted(interval, interval)
    pos = np.asarray(scan.seg_bits, np.int64)[interval] + np.arange(
        interval.size) - first
    bit = _bits(scan.pk, pos, 1)
    for i, c in enumerate(scan.comps):
        sel = scan.ci == i
        c.coef[scan.blk[sel], 0] |= bit[sel] << scan.al


def _ac_first(scan: _Scan) -> None:
    ln, run, size = scan.table(scan.ac, 0).lists("sym")
    pk, seg_bits, ri = memoryview(scan.pk), scan.seg_bits, scan.restart
    ss, se = scan.ss, scan.se
    sym_pos, sym_at = [], []
    add_pos, add_at = sym_pos.append, sym_at.append
    pos, eobrun = seg_bits[0], 0
    try:
        for b in range(scan.blk.size):
            if ri and b and b % ri == 0:
                pos, eobrun = seg_bits[b // ri], 0
            if eobrun:
                eobrun -= 1
                continue
            k = ss
            while k <= se:
                v = pk[pos]
                r, s = run[v], size[v]
                if s:
                    k += r
                    add_pos(pos)
                    add_at(b * 128 + k)
                    pos += ln[v] + s
                    k += 1
                elif r == 15:
                    pos += ln[v]
                    k += 16
                else:
                    pos += ln[v]
                    eobrun = 1 << r
                    if r:
                        eobrun += pk[pos] >> (16 - r)
                        pos += r
                    eobrun -= 1
                    break
    except IndexError:
        raise ValueError("JPEG: truncated scan data") from None
    pos = np.asarray(sym_pos, np.int64)
    at = np.asarray(sym_at, np.int64)
    tab = scan.table(scan.ac, 0)
    ln = scan.check_codes([tab], pos, np.zeros_like(pos))
    size = tab.symbol[scan.pk[pos]] & 15
    val = _extend(_bits(scan.pk, pos + ln, size), size)
    _store(scan.comps[0], scan.blk[at // 128], np.minimum(at % 128, 63),
           val << scan.al)


def _ac_refine(scan: _Scan) -> None:
    """Correction bits for the band's coefficients that were nonzero
    before this scan (one each, in k order, between the symbols), and
    the newly nonzero ones.  Their order is fixed by the nonzero mask
    before the scan, so the loop only counts: `zk` lists each block's
    zero coefficients, `nz` the nonzeros before each k."""
    ln, run, size = scan.table(scan.ac, 0).lists("sym")
    c = scan.comps[0]
    ss, se = scan.ss, scan.se
    band = c.coef[scan.blk, ss:se + 1] != 0           # [B, n]
    n = se - ss + 1
    nzcum = np.concatenate([np.zeros((band.shape[0], 1), np.int64),
                            np.cumsum(band, 1)], 1)   # [B, n + 1]
    order = np.argsort(band, axis=1, kind="stable")   # zeros first
    zk_np = (order + ss).astype(np.int64)
    zeros = (n - nzcum[:, -1]).tolist()
    nz = memoryview(nzcum.reshape(-1))
    zk = memoryview(zk_np.reshape(-1))
    pk, seg_bits, ri = memoryview(scan.pk), scan.seg_bits, scan.restart
    corr, new_at, new_sign = [], [], []
    add_corr, add_at, add_sign = corr.append, new_at.append, new_sign.append
    pos, eobrun = seg_bits[0], 0
    try:
        for b in range(scan.blk.size):
            if ri and b and b % ri == 0:
                pos, eobrun = seg_bits[b // ri], 0
            k, zi = ss, 0
            zb, nb = b * n, b * (n + 1) - ss
            if not eobrun:
                while k <= se:
                    v = pk[pos]
                    r, s = run[v], size[v]
                    pos += ln[v]
                    if s:
                        sign = pos
                        pos += 1
                    elif r != 15:
                        eobrun = 1 << r
                        if r:
                            eobrun += pk[pos] >> (16 - r)
                            pos += r
                        break
                    t = zi + r
                    if t >= zeros[b]:
                        raise ValueError("JPEG: corrupt progressive "
                                         "refinement")
                    tk = zk[zb + t]
                    cnt = nz[nb + tk] - nz[nb + k]
                    if cnt:
                        add_corr((pos, b, k, tk))
                        pos += cnt
                    if s:
                        add_at(b * 64 + tk)
                        add_sign(sign)
                    k, zi = tk + 1, t + 1
            if eobrun:
                cnt = nz[nb + se + 1] - nz[nb + k]
                if cnt:
                    add_corr((pos, b, k, se + 1))
                    pos += cnt
                eobrun -= 1
    except IndexError:
        raise ValueError("JPEG: truncated scan data") from None
    p1 = 1 << scan.al
    if corr:
        pos0, blk, k0, k1 = np.asarray(corr, np.int64).T
        first = nzcum[blk, k0 - ss]
        cnt = nzcum[blk, k1 - ss] - first
        seg = np.repeat(np.arange(cnt.size), cnt)
        j = np.arange(seg.size) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        # the (first + j)-th nonzero of the block's band
        nz_k = np.argsort(~band, axis=1, kind="stable") + ss
        b = blk[seg]
        kk = nz_k[b, first[seg] + j]
        bit = _bits(scan.pk, pos0[seg] + j, 1).astype(bool)
        b, kk = scan.blk[b[bit]], kk[bit]
        cur = c.coef[b, kk]
        c.coef[b, kk] = np.where(cur & p1, cur,
                                 np.where(cur >= 0, cur + p1, cur - p1))
    if new_at:
        at = np.asarray(new_at, np.int64)
        sign = _bits(scan.pk, np.asarray(new_sign, np.int64), 1)
        c.coef[scan.blk[at // 64], at % 64] = np.where(sign == 1, p1, -p1)


def _decode_scan(frame: _Frame, scan: _Scan) -> None:
    for c in scan.comps:
        if c.qt is None:
            raise ValueError("JPEG: scan before its quantization table")
    if not frame.progressive:
        if scan.ss != 0 or scan.se != 63 or scan.ah or scan.al:
            raise ValueError("JPEG: sequential scan with a spectral band")
        _sequential(scan)
        for c in scan.comps:
            c.bits[:] = 0
        return
    if scan.ss == 0:
        if scan.se != 0:
            raise ValueError("JPEG: progressive DC scan with AC terms")
        (_dc_refine if scan.ah else _dc_first)(scan)
    else:
        if len(scan.comps) != 1 or scan.se > 63 or scan.ss > scan.se:
            raise ValueError("JPEG: bad progressive AC scan")
        (_ac_refine if scan.ah else _ac_first)(scan)
    for c in scan.comps:
        c.bits[scan.ss:scan.se + 1] = scan.al


# --------------------------------------------------------- IDCT, upsample

CONST_BITS, PASS1_BITS = 13, 2
FIX = {k: v for k, v in (
    ("0_298631336", 2446), ("0_390180644", 3196), ("0_541196100", 4433),
    ("0_765366865", 6270), ("0_899976223", 7373), ("1_175875602", 9633),
    ("1_501321110", 12299), ("1_847759065", 15137), ("1_961570560", 16069),
    ("2_053119869", 16819), ("2_562915447", 20995), ("3_072711026", 25172))}


def _idct_1d(x: list, shift: int) -> list:
    """jpeg_idct_islow's 1-D pass on eight int64 arrays (inputs 0..7),
    descaled by `shift`.  Its all-AC-zero shortcuts give the same sums."""
    z1 = (x[2] + x[6]) * FIX["0_541196100"]
    tmp2 = z1 - x[6] * FIX["1_847759065"]
    tmp3 = z1 + x[2] * FIX["0_765366865"]
    tmp0 = (x[0] + x[4]) << CONST_BITS
    tmp1 = (x[0] - x[4]) << CONST_BITS
    t10, t13 = tmp0 + tmp3, tmp0 - tmp3
    t11, t12 = tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * FIX["1_175875602"]
    o0 = o0 * FIX["0_298631336"]
    o1 = o1 * FIX["2_053119869"]
    o2 = o2 * FIX["3_072711026"]
    o3 = o3 * FIX["1_501321110"]
    z1 = z1 * -FIX["0_899976223"]
    z2 = z2 * -FIX["2_562915447"]
    z3 = z3 * -FIX["1_961570560"] + z5
    z4 = z4 * -FIX["0_390180644"] + z5
    o0 += z1 + z3
    o1 += z2 + z4
    o2 += z2 + z3
    o3 += z1 + z4
    half = 1 << (shift - 1)
    return [(a + half) >> shift for a in (
        t10 + o3, t11 + o2, t12 + o1, t13 + o0,
        t13 - o0, t12 - o1, t11 - o2, t10 - o3)]


def _range_limit() -> np.ndarray:
    """The post-IDCT table indexed by (value & 1023): value + 128 clamped
    to 0..255 for -384..383, wrapping beyond as libjpeg's does."""
    i = np.arange(1024)
    return np.select([i < 128, i < 512, i < 896], [i + 128, 255, 0],
                     i - 896).astype(np.uint8)


RANGE_LIMIT = _range_limit()


def _idct_plane(c: _Component) -> np.ndarray:
    """Dequantize and inverse-transform every block: uint8 [bh*8, bw*8]."""
    out = np.empty((c.coef.shape[0], 8, 8), np.uint8)
    q = c.qt[NATURAL]                      # zigzag order, as coef
    for s in range(0, c.coef.shape[0], 8192):
        blk = (c.coef[s:s + 8192] * q)[:, ZIGZAG].reshape(-1, 8, 8)
        cols = _idct_1d([blk[:, i, :] for i in range(8)],
                        CONST_BITS - PASS1_BITS)       # per column: [N, 8]
        ws = np.stack(cols, 1)                         # [N, row, col]
        rows = _idct_1d([ws[:, :, i] for i in range(8)],
                        CONST_BITS + PASS1_BITS + 3)
        out[s:s + 8192] = RANGE_LIMIT[np.stack(rows, 2) & 1023]
    return (out.reshape(c.bh, c.bw, 8, 8).transpose(0, 2, 1, 3)
            .reshape(c.bh * 8, c.bw * 8))


def _upsample(c: _Component, plane: np.ndarray, frame: _Frame):
    """jdsample.c's upsampling of one component to the frame's size."""
    hx, vx = frame.hmax // c.h, frame.vmax // c.v
    x = plane[:c.dh, :c.dw].astype(np.int32)
    w, h = frame.width, frame.height
    if (hx, vx) == (1, 1):
        return x[:h, :w].astype(np.uint8)
    fancy_w = c.dw > 2
    if vx == 2 and (hx == 1 or (hx == 2 and fancy_w)):
        # triangle filter down the columns: 3/4 nearer row + 1/4 further
        up = np.concatenate([x[:1], x[:-1]])
        down = np.concatenate([x[1:], x[-1:]])
        near = [3 * x + up, 3 * x + down]
        if hx == 1:
            y = np.stack([(near[0] + 1) >> 2, (near[1] + 2) >> 2], 1)
            return y.reshape(-1, c.dw)[:h, :w].astype(np.uint8)
        rows = []
        for s in near:       # then across, on the column sums
            left = np.concatenate([s[:, :1], s[:, :-1]], 1)
            right = np.concatenate([s[:, 1:], s[:, -1:]], 1)
            rows.append(np.stack([(3 * s + left + 8) >> 4,
                                  (3 * s + right + 7) >> 4], 2
                                 ).reshape(s.shape[0], -1))
        y = np.stack(rows, 1).reshape(2 * c.dh, -1)
        return y[:h, :w].astype(np.uint8)
    if (hx, vx) == (2, 1) and fancy_w:
        left = np.concatenate([x[:, :1], x[:, :-1]], 1)
        right = np.concatenate([x[:, 1:], x[:, -1:]], 1)
        y = np.stack([(3 * x + left + 1) >> 2, (3 * x + right + 2) >> 2], 2)
        return y.reshape(c.dh, -1)[:h, :w].astype(np.uint8)
    y = np.repeat(np.repeat(x, vx, 0), hx, 1)
    return y[:h, :w].astype(np.uint8)


def _fix16(x: float) -> int:
    return int(x * 65536 + 0.5)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert with its 16-bit fixed-point tables."""
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15
    cr_r = (_fix16(1.40200) * x + half) >> 16
    cb_b = (_fix16(1.77200) * x + half) >> 16
    cr_g = -_fix16(0.71414) * x
    cb_g = -_fix16(0.34414) * x + half
    y = y.astype(np.int64)
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


# ----------------------------------------------------------------- markers


def _exif_orientation(body: bytes) -> int:
    """The orientation tag (0x0112) of an APP1 Exif block's IFD0, else 1."""
    tiff = body[6:]
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    e = "<" if tiff[:2] == b"II" else ">"
    off = struct.unpack(e + "I", tiff[4:8])[0]
    if off + 2 > len(tiff):
        return 1
    n = struct.unpack(e + "H", tiff[off:off + 2])[0]
    for i in range(n):
        p = off + 2 + 12 * i
        if p + 12 > len(tiff):
            break
        tag, typ = struct.unpack(e + "HH", tiff[p:p + 4])
        if tag == 0x0112 and typ == 3:
            return struct.unpack(e + "H", tiff[p + 8:p + 10])[0]
    return 1


def decode_jpeg(data: bytes):
    """(pixels, EXIF orientation) of a JPEG file's bytes: uint8 [H, W]
    for one component, [H, W, 3] RGB for three."""
    arr = np.frombuffer(data, np.uint8)
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file")
    qts, dc_tabs, ac_tabs = {}, {}, {}
    frame, restart, orientation = None, 0, None
    jfif, adobe = False, None
    pos = 2
    while True:
        while pos < len(data) and data[pos] != 0xFF:
            pos += 1                      # garbage before a marker
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            break                          # no EOI: decode what was read
        m = data[pos]
        pos += 1
        if m == 0xD9:
            break
        if m in (0x01, 0xD8) or 0xD0 <= m <= 0xD7:
            continue
        length = struct.unpack(">H", data[pos:pos + 2])[0]
        body = data[pos + 2:pos + length]
        pos += length
        if m in REFUSED_SOF:
            _refuse(REFUSED_SOF[m])
        if m in (0xC0, 0xC1, 0xC2):
            if frame is not None:
                raise ValueError("JPEG: two frames")
            frame = _Frame(body, m)
        elif m == 0xDB:
            p = 0
            while p < len(body):
                pq, tq = body[p] >> 4, body[p] & 15
                n = 128 if pq else 64
                vals = np.frombuffer(body[p + 1:p + 1 + n],
                                     ">u2" if pq else np.uint8)
                qt = np.empty(64, np.int64)
                qt[NATURAL] = vals
                qts[tq] = qt
                p += 1 + n
        elif m == 0xC4:
            p = 0
            while p < len(body):
                tc, th = body[p] >> 4, body[p] & 15
                counts = body[p + 1:p + 17]
                n = sum(counts)
                symbols = body[p + 17:p + 17 + n]
                if tc == 0 and max(symbols, default=0) > 15:
                    raise ValueError("JPEG: bad DC Huffman table")
                tab = _Table(counts, symbols)
                (ac_tabs if tc else dc_tabs)[th] = tab
                p += 17 + n
        elif m == 0xDD:
            restart = struct.unpack(">H", body[:2])[0]
        elif m == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif m == 0xE1 and body[:6] == b"Exif\x00\x00" and orientation is None:
            orientation = _exif_orientation(body)
        elif m == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif m == 0xDA:
            if frame is None:
                raise ValueError("JPEG: scan before the frame header")
            scan = _Scan(frame, body, dc_tabs, ac_tabs, restart, arr, pos)
            for c in scan.comps:
                if c.qt is None and c.tq in qts:
                    c.qt = qts[c.tq].copy()
            _decode_scan(frame, scan)
            pos = scan.end
    if frame is None:
        raise ValueError("JPEG: no frame header")
    for c in frame.comps:
        if c.qt is None:
            raise ValueError("JPEG: a component was never coded")
        if frame.progressive and (c.bits[0] < 0 or (c.bits[1:10] != 0).any()):
            _refuse("a progressive file whose refinement stops short "
                    "(block smoothing)")
    planes = [_upsample(c, _idct_plane(c), frame) for c in frame.comps]
    if len(planes) == 1:
        return planes[0], orientation or 1
    ids = [c.id for c in frame.comps]
    if jfif:
        ycc = True
    elif adobe is not None:
        ycc = adobe != 0
    else:
        ycc = ids != [82, 71, 66]
    img = _ycc_to_rgb(*planes) if ycc else np.stack(planes, -1)
    return img, orientation or 1
