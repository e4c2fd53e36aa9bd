"""numpy/Python emulations of the arithmetic of the port's CUDA kernels
(``redux_tpu_torch/csrc``), statement for statement where it matters, for
the CPU tests: the reciprocal quotient (``rxt::div53``), the coder's total
(``rxt::Count``), the renormalisation (``rxt::renorm``), the coder step and
its branch-free emission (``rxt::Coder``, ``rxt::BitWriter``) and K1's
chunk step (``rxt::model_chunk``).  The kernels themselves run only on the
card; these run their algorithms here."""

import numpy as np

M32 = 0xFFFFFFFF
OWN, SLOTS = 9, 32 * 9  # row entries a lane owns in a chunk step; ints a row
EARLIER = np.tril(np.ones((32, 32), bool), -1)  # [j, i]: i < j


def div53(a, b):
    """``rxt::div53`` over uint64 arrays, for dividends below 2**53: the
    truncated product with the rounded reciprocal, corrected by one."""
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
