"""numpy/Python emulations of the arithmetic of the port's CUDA kernels
(``redux_tpu_torch/csrc``), statement for statement where it matters, for
the CPU tests: the reciprocal quotient (``rxt::div53``), the coder's total
(``rxt::Count``), the renormalisation (``rxt::renorm``), the coder step and
its branch-free emission (``rxt::Coder``, ``rxt::BitWriter``), K1's
chunk step (``rxt::model_chunk``), the Fenwick model of K3 and K5
(``rxt::Fenwick``), one thread of K5 (``encode_m_thread``) and one warp
of K3's warp route (``decode_warp``).  The kernels themselves run only on
the card; these run their algorithms here."""

import numpy as np

M32 = 0xFFFFFFFF
OWN, SLOTS = 9, 32 * 9  # row entries a lane owns in a chunk step; ints a row
EARLIER = np.tril(np.ones((32, 32), bool), -1)  # [j, i]: i < j
NODES = 257  # Fenwick nodes 1..257 over the 257 symbol frequencies
WALK = 9  # ``rxt::kWalk``: nodes of an update walk
GROUP = 16  # K5's positions a round: symbols a load
LANE_ROW = 8  # K3's warp route: row entries a lane owns
LANES = np.arange(32)


def div53(a, b):
    """``rxt::div53`` over uint64 arrays, for dividends below 2**63 and
    quotients below 2**40: the truncated product with the rounded
    reciprocal, corrected by one."""
    q = (a.astype(np.float64) * (1.0 / b.astype(np.float64))).astype(np.uint64)
    qb = q * b
    over = qb > a
    q = np.where(over, q - np.uint64(1), q)
    under = ~over & (a - np.where(over, a, qb) >= b)
    return np.where(under, q + np.uint64(1), q)


def div53_int(a: int, b: int) -> int:
    return int(div53(np.array([a], np.uint64), np.array([b], np.uint64))[0])


def count_at(t: int, init_total: int, delta: int, tfreeze: int) -> int:
    """``rxt::Count``: the coder's total at position t of K2 and K4."""
    return max(init_total + delta * min(t, tfreeze), 1)


def renorm(low: int, high: int, cb: int):
    """``rxt::renorm``: returns ``(low, high, n1, n3)``."""
    cmax = (1 << cb) - 1
    n1 = max(cb - (low ^ high).bit_length(), 0)
    low1 = (low << n1) & cmax
    high1 = ((high << n1) | ((1 << n1) - 1)) & cmax
    a = 32 - (((low1 << (33 - cb)) & M32) ^ M32).bit_length()
    b = 32 - ((high1 << (33 - cb)) & M32).bit_length()
    n3 = min(a, b, cb - 1)
    low = (low1 << n3) & (cmax >> 1)
    high = (((high1 << n3) | ((1 << n3) - 1)) & (cmax >> 1)) | (1 << (cb - 1))
    return low, high, n1, n3


class Coder:
    """``rxt::Coder`` of one block with the kFits53 quotients: ``step``
    narrows over ``count`` by :func:`div53_int`, renormalises and emits
    ``[b1][pending x !b1][n1-1 prefix bits]`` (a put of 0 bits when
    n1 = 0); ``terminate`` emits the v2 terminator; ``finish`` returns
    ``(words, byte_len, ovf)`` as the kernels store them."""

    def __init__(self, cap: int, cb: int):
        self.cap, self.cb = cap, cb
        self.out = [0] * cap
        self.acc = self.accbits = self.nw = 0
        self.low, self.high, self.pending, self.ovf = 0, (1 << cb) - 1, 0, False

    def _put(self, v: int, n: int) -> None:  # n <= 32, v < 2**n
        assert 0 <= n <= 32 and 0 <= v < 1 << n
        acc = (self.acc << n) | v
        accbits = self.accbits + n
        full = accbits >= 32
        if full and self.nw < self.cap:
            self.out[self.nw] = (acc >> (accbits - 32)) & M32
        accbits -= 32 if full else 0
        self.nw += full
        self.acc, self.accbits = acc & ((1 << accbits) - 1), accbits

    def _put64(self, v: int, n: int) -> None:
        nh = n - 32 if n > 32 else 0
        self._put(v >> 32, nh)
        self._put(v & M32, n - nh)

    def _emit(self, lead: int, rest: int, rest_len: int, on: bool = True) -> None:
        big = rest_len + 1 + self.pending > 64
        first = (lead | (rest_len >= 1)) if big else lead
        run = 63 - rest_len if big else self.pending
        self.ovf |= on and big
        opp = 0 if lead else (1 << run) - 1
        piece = (first << (run + rest_len)) | (opp << rest_len) | rest
        self._put64(piece if on else 0, 1 + run + rest_len if on else 0)

    def step(self, flo: int, fhi: int, count: int) -> None:
        rng = self.high - self.low + 1
        nlow = self.low + div53_int(rng * flo, count)
        self.high = self.low + div53_int(rng * fhi, count) - 1
        narrowed = self.low = nlow
        self.low, self.high, n1, n3 = renorm(self.low, self.high, self.cb)
        on = n1 > 0
        rest_len = n1 - 1 if on else 0
        prefix = narrowed >> (self.cb - n1)
        self._emit(prefix >> rest_len, prefix & ((1 << rest_len) - 1), rest_len, on)
        self.pending = (0 if on else self.pending) + n3

    def terminate(self) -> None:
        tq = (self.low + (1 << (self.cb - 2)) - 1) >> (self.cb - 2)
        self._emit(tq >> 1, tq & 1, 1)

    def finish(self):
        words = list(self.out)
        if self.accbits > 0 and self.nw < self.cap:
            words[self.nw] = (self.acc << (32 - self.accbits)) & M32
        return words, (self.nw * 32 + self.accbits + 7) >> 3, self.ovf


def model_chunk(row, v, n_act: int, delta: int):
    """``rxt::model_chunk`` for one block: ``row`` (SLOTS,) int64 at the
    chunk's start, updated in place; ``v`` the chunk's 32 symbols (0 past
    the block); the first ``n_act`` positions adapt.  Returns the 32
    positions' ``(lo, hi)``: in-chunk ranks over the earlier active
    positions, then the row update from a histogram of the active symbols,
    lane l owning entries 9l .. 9l+8 (an in-lane prefix and an exclusive
    scan of the lane totals)."""
    act = np.arange(32) < n_act
    m = EARLIER & act[None, :]
    lt = (m & (v[None, :] < v[:, None])).sum(1)
    le = (m & (v[None, :] <= v[:, None])).sum(1)
    lo, hi = row[v] + delta * lt, row[v + 1] + delta * le
    if n_act:
        h = np.bincount(v[act], minlength=SLOTS).reshape(32, OWN)
        lane_total = h.sum(1)
        below = np.cumsum(lane_total) - lane_total  # exclusive warp scan
        in_lane = np.cumsum(h, 1) - h  # exclusive in-lane prefix
        row += delta * (below[:, None] + in_lane).reshape(-1)
    return lo, hi


def lowbit(i: int) -> int:
    return i & -i


def fenwick_tree(cdf):
    """``rxt::Fenwick::init``: node i (1-based; index 0 unused) holds the
    frequencies of symbols i - lowbit(i) .. i - 1."""
    node = [0] * (NODES + 1)
    for i in range(1, NODES + 1):
        node[i] = int(cdf[i] - cdf[i - lowbit(i)])
    return node


def fenwick_add(node, v: int, d: int) -> None:
    """freq[v] += d as the loop walk up from node v + 1."""
    i = v + 1
    while i <= NODES:
        node[i] += d
        i += lowbit(i)


def fenwick_prefix(node, v: int):
    """``rxt::Fenwick::prefix`` for a byte v: one node a set bit b of v,
    node (v >> b) << b, unrolled over b < 8; ``low`` sums the terms of v's
    trailing ones.  Returns ``(prefix(v), low)``."""
    ones = v & ~(v + 1)  # v's trailing ones
    total = low = 0
    for b in range(8):
        n = node[(v >> b) << b] if (v >> b) & 1 else 0
        total += n
        low += n if (ones >> b) & 1 else 0
    return total, low


def load_walk(node, v: int):
    """``rxt::Fenwick::load_walk``: the nodes the update freq[v] += d
    touches for a byte v in closed form, node (v | (2**b - 1)) + 1 for
    every b < WALK (repeats included), and the values they hold."""
    idx = [(v | ((1 << b) - 1)) + 1 for b in range(WALK)]
    return idx, [node[i] for i in idx]


def store_walk(node, walk, d: int) -> None:
    """``rxt::Fenwick::store_walk``: each walk node becomes its loaded value + d."""
    for i, v in zip(*walk):
        node[i] = v + d


def _load_syms(row, t: int, n: int, vec: bool):
    """K5's ``load_syms``: symbols t .. t + GROUP - 1 below n (zeros past
    it) as four little-endian u32 words, one 16-byte load when the group
    is whole and ``vec``, byte loads otherwise."""
    if t + GROUP <= n and vec:
        return [int(w) for w in np.frombuffer(row[t : t + GROUP].tobytes(), "<u4")]
    w = [0] * (GROUP // 4)
    for j in range(GROUP):
        if t + j < n:
            w[j >> 2] |= int(row[t + j]) << (8 * (j & 3))
    return w


def encode_m_thread(row, n: int, init_cum, params, n_words: int, delta: int, n_rounds: int):
    """One block of a CTA of ``csrc/encode_m.cu``: its lane of a model warp
    and its lane of a coder warp, for a block of ``row`` (the K symbols of
    its row, uint8) and length ``n`` (-1 for a pad lane).  Both lanes run
    the CTA's ``n_rounds`` rounds of GROUP positions (its longest block
    decides).  The model lane: the round's symbols loaded during the round
    before (zeros past n); per position the closed-form bounds into the
    round's half of the tile and the update walk stored as node + d, d =
    delta while the position is below n and the total under freq_max, 0
    otherwise (no branch).  The coder lane: the half, a whole round with
    no guards (runs of 8 on the card) and the last one guarded, each
    position coded (``rxt::Coder``) over its own copy of the total before
    the update.  The barriers order the two lanes round by round, as here.
    Returns ``(words, byte_len, ovf)`` as the kernel stores them."""
    k = len(row)
    vec = k % GROUP == 0
    n = min(n, k)
    node = fenwick_tree(np.asarray(init_cum, np.int64))
    base, tot = int(init_cum[0]), int(init_cum[NODES])
    tot_c = tot
    tile = [[(0, 0)] * GROUP for _ in range(2)]
    coder = Coder(n_words, params.code_bits)
    nxt = _load_syms(row, 0, n, vec)
    for r in range(n_rounds):
        h, t0 = r & 1, r * GROUP
        cur, nxt = nxt, _load_syms(row, t0 + GROUP, n, vec)
        for j in range(GROUP):  # the model lane
            v = (cur[j >> 2] >> (8 * (j & 3))) & 0xFF
            pre, low = fenwick_prefix(node, v)
            flo = base + pre
            up = load_walk(node, v)
            tile[h][j] = (flo, flo + up[1][0] - low)
            d = delta if t0 + j < n and tot < params.freq_max else 0
            store_walk(node, up, d)
            tot += d
        whole = t0 + GROUP <= n  # the coder lane
        for j in range(GROUP):
            if whole or t0 + j < n:
                coder.step(*tile[h][j], tot_c)
                tot_c += delta if tot_c < params.freq_max else 0
    if n >= 0:
        coder.terminate()
    return coder.finish()


def narrow(p, c, count: int, rr: float):
    """``narrow`` of ``csrc/decode.cu`` for the ints ``c`` of a sequence:
    floor(c * range / count) from ``rr`` = range * (1/count) in double.
    The kernel's fused multiply-add rounds the exact c * rr + 2**52 to an
    integer, ties to even (here in exact integer arithmetic); then one is
    taken off where q * count passes ``p`` = c * range."""
    num, den = rr.as_integer_ratio()
    out = []
    for pe, ce in zip(p, c):
        q, r = divmod(int(ce) * num, den)
        q += 2 * r > den or (2 * r == den and q & 1)
        out.append(q - (q * count > int(pe)))
    return out


def renorm32(low: int, high: int, cb: int):
    """``renorm32`` of ``csrc/decode.cu``: ``renorm`` on an interval held in
    32 bits (a shift by 32 gives 0).  Returns ``(low, high, n1, n3)``."""
    cmax = M32 >> (32 - cb)
    n1 = max(32 - (low ^ high).bit_length() - (32 - cb), 0)
    low1 = (low << n1) & M32 & cmax
    high1 = (((high << n1) & M32) | ((1 << n1) - 1)) & cmax
    a = 32 - (((low1 << (33 - cb)) & M32) ^ M32).bit_length()
    b = 32 - ((high1 << (33 - cb)) & M32).bit_length()
    n3 = min(a, b, cb - 1)
    low = (low1 << n3) & (cmax >> 1)
    high = (((high1 << n3) | ((1 << n3) - 1)) & (cmax >> 1)) | (1 << (cb - 1))
    return low, high, n1, n3


class WarpBits:
    """K3's ``BitReader``, the same in every lane: MSB-first reads of a row
    of big-endian u32 words, a word loaded one refill early, zero words
    past the row."""

    def __init__(self, words):
        self.w = [int(x) & M32 for x in words]
        self.buf = self.nb = self.next = 0
        self.ahead = self.w[0] if self.w else 0

    def get(self, n: int) -> int:
        if n == 0:
            return 0
        if self.nb < n:
            self.buf |= self.ahead << (32 - self.nb)
            self.nb += 32
            self.next += 1
            self.ahead = self.w[self.next] if self.next < len(self.w) else 0
        v = self.buf >> (64 - n)
        self.buf = (self.buf << n) & ((1 << 64) - 1)
        self.nb -= n
        return v


def decode_warp(words, n_sym: int, init_cum, params, k: int, delta: int):
    """One warp of K3's warp route (``csrc/decode.cu``, the untemplated
    ``decode_kernel``) on one block: ``words`` its row, ``n_sym`` its
    length.  Lane l's registers are row l of ``c`` (32, 9): cdf[8l .. 8l+8].
    count at position t is init + delta * min(t, tfreeze), its reciprocal
    taken by lane j for position t0 + j of each 32.  Per symbol, each lane
    tests its entries (``c * range <= a`` and ``c != count``, a = (z+1) *
    count - 1); the ballot of its first entry names the owning lane; each
    lane picks its last qualifying entry by the kernel's tree of selects
    and narrows over it and the next entry (``narrow``, before the ballot
    is read); three shuffles bring the owner's pick, dlo and dhi - 1 to the
    warp; low, high and z are warp-uniform and held in 32 bits, with the
    kernel's ``renorm32`` and the bits; the update adds delta to each
    lane's entries above sym while t < tfreeze.  Lane j keeps the symbol at t0 + j of each
    32.  Returns the row of ``k`` bytes."""
    cb = params.code_bits
    cmax = (1 << cb) - 1
    ic = np.asarray(init_cum, np.int64)
    c = ic[LANE_ROW * LANES[:, None] + np.arange(LANE_ROW + 1)].astype(np.uint64)
    init_total = int(ic[NODES])
    tfreeze = max(-(-(params.freq_max - init_total) // delta), 0)
    rd = WarpBits(words)
    low, high = 0, cmax
    z = rd.get(cb)
    n = min(n_sym, k)
    out = np.zeros(k, np.uint8)
    for t0 in range(0, k, 32):
        rc_lane = [1.0 / (init_total + delta * min(t0 + lane, tfreeze)) for lane in range(32)]
        mine = np.zeros(32, np.uint64)
        j = 0
        while j < 32 and t0 + j < n:
            t = t0 + j
            upd = t < tfreeze
            count = init_total + delta * (t if upd else tfreeze)
            rc = rc_lane[j]
            rm1 = (high - low) & M32
            rr = float(rm1 + 1) * rc  # the kernel's fma(rm1, rc, rc): one rounding
            a = count * z + count - 1
            q = (c * np.uint64(rm1) + c <= np.uint64(a)) & (c != np.uint64(count))  # (32, 9)
            i01, i23, i45, i67 = (np.where(q[:, 2 * m + 1], 2 * m + 1, 2 * m) for m in range(4))
            l01, l23, l45, l67 = (np.where(q[:, 2 * m + 1], c[:, 2 * m + 1], c[:, 2 * m])
                                  for m in range(4))
            h01, h23, h45, h67 = (np.where(q[:, 2 * m + 1], c[:, 2 * m + 2], c[:, 2 * m + 1])
                                  for m in range(4))
            i03, i47 = np.where(q[:, 2], i23, i01), np.where(q[:, 6], i67, i45)
            l03, l47 = np.where(q[:, 2], l23, l01), np.where(q[:, 6], l67, l45)
            h03, h47 = np.where(q[:, 2], h23, h01), np.where(q[:, 6], h67, h45)
            i07 = np.where(q[:, 4], i47, i03)
            l07, h07 = np.where(q[:, 4], l47, l03), np.where(q[:, 4], h47, h03)
            i = np.where(q[:, 8], 8, i07)
            lo = np.where(q[:, 8], c[:, 8], l07)
            hi = np.where(q[:, 8], np.uint64(count), h07)
            dlo = narrow(lo * np.uint64(rm1) + lo, lo, count, rr)
            dhi = narrow(hi * np.uint64(rm1) + hi, hi, count, rr)
            own = int(sum(1 << lane for lane in range(32) if q[lane, 0]))
            src = (own | 1).bit_length() - 1  # bfind
            dl, dhm1 = dlo[src] & M32, (dhi[src] - 1) & M32
            sym = LANE_ROW * src + int(i[src])
            high = (low + dhm1) & M32
            low = (low + dl) & M32
            low, high, n1, n3 = renorm32(low, high, cb)
            nbits = min(n1 + n3, cb)
            z = ((((z - dl) & M32) << nbits) | rd.get(nbits)) & cmax
            d = sym - LANE_ROW * LANES
            c += np.where(upd & (np.arange(LANE_ROW + 1)[None, :] > d[:, None]), delta, 0).astype(
                np.uint64)
            mine = np.where(LANES == j, np.uint64(sym), mine)
            j += 1
        m = min(32, k - t0)
        out[t0 : t0 + m] = (mine[:m] & np.uint64(0xFF)).astype(np.uint8)
    return out
