"""A JPEG writer for the codec tests: given each component's quantized
DCT coefficients, it writes them as a baseline (sequential) file or as a
progressive file of any legal scan script, the entropy coding mirroring
what libjpeg's ``jdphuff.c`` reads (DC first and refine, AC first with EOB
runs and ZRLs, AC refine with its correction bits after each symbol and
after an EOB run), with restart intervals.  cv2 writes progressive files
with one script only (``jpeg_simple_progression``); this writes the others
a JPEG may hold, for cv2's decoder to judge the port's.

``random_script(rng, n_components, complete=True)`` draws a legal script:
the DC band first coded at some Al and refined down to 0, interleaved or a
scan per component; the AC coefficients of each component cut into bands,
each first coded at its own Al and refined band by band (the refinement
bands cut anew) down to 0, the components' scans in a random order.  With
``complete=False`` one scan that codes the last bit of its coefficients is
left out; ``coef_bits`` gives what libjpeg's ``coef_bits`` holds after a
script (the Al of the last scan that coded each coefficient, -1 for none).
"""
import struct

import numpy as np

ZIGZAG = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
          12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
          35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
          58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]

# Huffman tables that code every symbol they may be asked for: DC symbols
# 0-15 (4 and 5 bits), AC symbols 0-255 (8 and 9 bits)
DC_COUNTS = [0, 0, 0, 14, 2] + [0] * 11
AC_COUNTS = [0] * 7 + [254, 2] + [0] * 7


def _codes(counts):
    table, code, sym = {}, 0, 0
    for length, n in enumerate(counts, 1):
        for _ in range(n):
            table[sym] = (code, length)
            code, sym = code + 1, sym + 1
        code <<= 1
    return table


DC_CODES, AC_CODES = _codes(DC_COUNTS), _codes(AC_COUNTS)


class _Bits:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value, size):
        for i in range(size - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc, self.n = 0, 0

    def flush(self):
        while self.n:
            self.put(1, 1)


def _category(v):
    return int(abs(v)).bit_length()


def _value_bits(v, size):
    return v if v >= 0 else (v - 1) & ((1 << size) - 1)


class _Scan:
    """The entropy coder of one scan: the EOB run and its buffered
    correction bits, the DC predictions."""

    def __init__(self, bits, n):
        self.bits, self.eobrun, self.be, self.pred = bits, 0, [], [0] * n

    def symbol(self, codes, s):
        self.bits.put(*codes[s])

    def flush_eobrun(self):
        if self.eobrun:
            r = self.eobrun.bit_length() - 1
            self.symbol(AC_CODES, r << 4)
            if r:
                self.bits.put(self.eobrun & ((1 << r) - 1), r)
            for b in self.be:
                self.bits.put(b, 1)
            self.eobrun, self.be = 0, []

    def end_of_block(self, corrections):
        self.eobrun += 1
        self.be += corrections
        if self.eobrun == 0x7FFF:
            self.flush_eobrun()

    def dc_first(self, ci, coef, al):
        v = int(coef[0]) >> al
        diff = v - self.pred[ci]
        self.pred[ci] = v
        s = _category(diff)
        self.symbol(DC_CODES, s)
        if s:
            self.bits.put(_value_bits(diff, s), s)

    def dc_refine(self, coef, al):
        self.bits.put((int(coef[0]) >> al) & 1, 1)

    def ac_first(self, coef, ss, se, al):
        r = 0
        for k in range(ss, se + 1):
            c = int(coef[ZIGZAG[k]])
            v = abs(c) >> al
            if v == 0:
                r += 1
                continue
            self.flush_eobrun()
            while r > 15:
                self.symbol(AC_CODES, 0xF0)
                r -= 16
            s = _category(v)
            self.symbol(AC_CODES, (r << 4) | s)
            self.bits.put(_value_bits(v if c > 0 else -v, s), s)
            r = 0
        if r:
            self.end_of_block([])

    def ac_refine(self, coef, ss, se, al):
        # each position: 0 still zero, 1 newly nonzero, 2 nonzero before
        # (its correction bit is the bit at al)
        mags = [abs(int(coef[ZIGZAG[k]])) >> al for k in range(ss, se + 1)]
        kind = [0 if m == 0 else 1 if m == 1 else 2 for m in mags]
        k, n = 0, len(kind)
        while 1 in kind[k:]:
            u = kind.index(1, k)
            while kind[k:u].count(0) > 15:
                # a ZRL covers the positions up to the 16th zero
                zeros, p = 0, k
                while zeros < 16:
                    zeros += kind[p] == 0
                    p += 1
                self.flush_eobrun()
                self.symbol(AC_CODES, 0xF0)
                for q in range(k, p):
                    if kind[q] == 2:
                        self.bits.put(mags[q] & 1, 1)
                k = p
            self.flush_eobrun()
            self.symbol(AC_CODES, (kind[k:u].count(0) << 4) | 1)
            self.bits.put(1 if coef[ZIGZAG[ss + u]] > 0 else 0, 1)
            for q in range(k, u):
                if kind[q] == 2:
                    self.bits.put(mags[q] & 1, 1)
            k = u + 1
        if k < n:
            self.end_of_block([mags[q] & 1 for q in range(k, n) if kind[q] == 2])


def _segment(marker, body):
    return b"\xff" + bytes([marker]) + struct.pack(">H", len(body) + 2) + body


def _dht(index, counts):
    return bytes([index]) + bytes(counts) + bytes(range(sum(counts)))


def write(coefs, sampling, width, height, script=None, restart=0, qtable=None):
    """A JPEG of ``coefs`` (a list per component of (blocks down, blocks
    across, 64) natural-order arrays, sized to whole MCUs), ``sampling`` a
    list of (h, v) per component; ``script`` a list of scans
    (components, Ss, Se, Ah, Al) for a progressive file, None for a
    baseline one.  Quantization table 0 (``qtable``, default all ones)
    serves every component."""
    q = np.ones(64, np.uint8) if qtable is None else np.asarray(qtable, np.uint8)
    n = len(coefs)
    out = bytearray(b"\xff\xd8")
    out += _segment(0xDB, bytes([0]) + bytes(int(q[ZIGZAG[k]]) for k in range(64)))
    sof = struct.pack(">BHHB", 8, height, width, n)
    for ci, (h, v) in enumerate(sampling):
        sof += bytes([ci + 1, (h << 4) | v, 0])
    out += _segment(0xC2 if script is not None else 0xC0, sof)
    out += _segment(0xC4, _dht(0x00, DC_COUNTS) + _dht(0x10, AC_COUNTS))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    for comps, ss, se, ah, al in (script or [(tuple(range(n)), 0, 63, 0, 0)]):
        sos = bytes([len(comps)]) + b"".join(bytes([c + 1, 0x00]) for c in comps)
        out += _segment(0xDA, sos + bytes([ss, se, (ah << 4) | al]))
        bits = _Scan(_Bits(), n)
        if len(comps) == 1:
            c = comps[0]
            h, v = sampling[c]
            bw = -(-(-(-width * h // hmax)) // 8)
            bh = -(-(-(-height * v // vmax)) // 8)
            units = [[(c, by, bx)] for by in range(bh) for bx in range(bw)]
        else:
            units = [[(c, my * sampling[c][1] + y, mx * sampling[c][0] + x) for c in comps
                      for y in range(sampling[c][1]) for x in range(sampling[c][0])]
                     for my in range(mcuy) for mx in range(mcux)]
        for i, unit in enumerate(units):
            if restart and i and i % restart == 0:
                bits.flush_eobrun()
                bits.bits.flush()
                bits.bits.out += bytes([0xFF, 0xD0 + (i // restart - 1) % 8])
                bits.pred = [0] * n
            for c, by, bx in unit:
                coef = coefs[c][by, bx]
                if script is None:
                    bits.dc_first(c, coef, 0)
                    bits.ac_first(coef, 1, 63, 0)
                    bits.flush_eobrun()
                elif ss == 0:
                    if ah == 0:
                        bits.dc_first(c, coef, al)
                    else:
                        bits.dc_refine(coef, al)
                elif ah == 0:
                    bits.ac_first(coef, ss, se, al)
                else:
                    bits.ac_refine(coef, ss, se, al)
        bits.flush_eobrun()
        bits.bits.flush()
        out += bits.bits.out
    return bytes(out + b"\xff\xd9")


def random_coefficients(rng, sampling, width, height):
    """Seeded coefficients for every block of whole MCUs: a DC level, AC
    falling off with frequency, some of every magnitude and sign."""
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    out = []
    for h, v in sampling:
        shape = (mcuy * v, mcux * h, 64)
        scale = 40.0 / (1 + np.arange(64))
        c = rng.normal(0, 1, shape) * scale * rng.choice([0, 1], shape, p=[0.4, 0.6])
        c[..., 0] = rng.integers(-300, 300, shape[:2])
        out.append(np.round(c).astype(np.int16))
    return out


def _bands(rng, lo, hi):
    if hi <= lo:
        return [(lo, hi)]
    cuts = sorted(set(int(x) for x in rng.integers(lo + 1, hi + 1, rng.integers(0, 4))))
    edges = [lo] + cuts + [hi + 1]
    return [(a, b - 1) for a, b in zip(edges, edges[1:])]


def coef_bits(script, n):
    """(n, 64): the Al of the last scan of ``script`` that coded each
    coefficient of each component, -1 where none did."""
    bits = np.full((n, 64), -1)
    for comps, ss, se, _, al in script:
        for c in comps:
            bits[c, ss:se + 1] = al
    return bits


def random_script(rng, n, complete=True):
    """A legal progressive scan script for ``n`` components; with
    ``complete=False``, one scan that codes the last bit of its
    coefficients is left out."""
    scans = []
    dc_al = int(rng.integers(0, 3))
    if n > 1 and rng.random() < 0.6:
        groups = [tuple(range(n))]
    else:
        groups = [(c,) for c in range(n)]
    for g in groups:
        scans.append((g, 0, 0, 0, dc_al))
    dc_refines = [(g, 0, 0, al + 1, al) for al in range(dc_al - 1, -1, -1) for g in groups]
    per_comp = []
    for c in range(n):
        queue = []
        for ss, se in _bands(rng, 1, 63):
            al = int(rng.integers(0, 4))
            queue.append([((c,), ss, se, 0, al)])
            for a in range(al - 1, -1, -1):
                queue[-1] += [((c,), s, e, a + 1, a) for s, e in _bands(rng, ss, se)]
        per_comp.append(queue)
    # the components' band chains interleaved at random, each chain in order
    chains = [chain for queue in per_comp for chain in queue] + [dc_refines]
    pos = [0] * len(chains)
    while any(p < len(ch) for p, ch in zip(pos, chains)):
        live = [i for i, (p, ch) in enumerate(zip(pos, chains)) if p < len(ch)]
        i = live[int(rng.integers(len(live)))]
        scans.append(chains[i][pos[i]])
        pos[i] += 1
    if not complete:
        # a scan no later one builds on: a band's (or the DC's) last bit
        droppable = [i for i, s in enumerate(scans) if s[4] == 0 and (s[1] > 0 or s[3] > 0)]
        if droppable:
            drop = droppable[int(rng.integers(len(droppable)))]
            scans = scans[:drop] + scans[drop + 1:]
    return scans
