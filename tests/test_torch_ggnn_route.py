"""Kernels B1 and B2's wrapper and the arithmetic of their tensor-core
variant, on the CPU (the kernels themselves run only on the card:
tests/test_torch_cuda.py).

- Routing: stand-in libraries record every entry point the wrapper calls
  and, where asked, read their arguments through their addresses as dense
  arrays and write what the kernel computes, in plain torch. Every bucket
  of the main paths (the serving ladder's N 2,048 and 4,096, the megabatch
  shape's 5,120, the training buckets up to 16,768, all at width 128)
  reaches the tensor-core entry points, forward and backward, in B1, B2
  and B3, and so do the analysis families' widths 192, 224 and 288 (and a
  width that pads to one of them), with the width passed to every entry
  and the weights padded per gate; a width the tensor-core kernels are
  not written for reaches the FFMA ones; a failed launch raises; the
  counters equal ``launches_per_call`` and ``bwd_launches_per_call``.
- Arithmetic of the 3xTF32 split: numpy's emulation of ``cvt.rna.tf32``
  gives ``big + small`` within 2^-22 of ``|x|`` (the split's bound: each
  part keeps 11 significant bits), and the three products within 1e-6 of
  the float64 product's largest value at K 128 and 384 (the dropped
  small.small term and the split's residue, each below 2^-22 of
  ``|a||b|``).
- The edge sum's closed form: a Python mirror of ``repeat_add``
  (``csrc/ggnn_tc.cuh``) equals the serial float32 chain bitwise, for
  random rows, run lengths up to 2^15, accumulators starting at zero, of
  the row's sign and of the other sign, zero rows, subnormal and huge
  values (bitwise: the kernel's sum must be the serial sum).

Tolerances: the stand-ins compute in float32 plain torch on fresh copies
of their operands, on one thread, so the wrapper's forward and backward
equal the same functions chained directly on the call's tensors bit for
bit; against the plain versions they hold within a first-order float32
error bound that scales with each result's sum of absolute terms
(``_error_bounds`` states the derivation).
"""

import ctypes
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deepdfa_tpu_torch.ops import fused_ggnn as fg  # noqa: E402
from deepdfa_tpu_torch.ops import megabatch as mb  # noqa: E402

F32, I32 = np.float32, np.int32
# node counts of the main paths' buckets at width 128: the serving ladder,
# the megabatch shape, the training buckets fit derives for the synthetic
# corpus at 256 graphs a batch
MAIN_PATH_NODES = (2048, 4096, 5120, 4224, 8448, 16768)


def _dense(ptr, shape, dtype):
    """The ``shape`` array of ``dtype`` at address ``ptr``, dense."""
    n = int(np.prod(shape)) * np.dtype(dtype).itemsize
    buf = (ctypes.c_char * n).from_address(ptr)
    return torch.from_numpy(np.frombuffer(buf, dtype=dtype).reshape(shape))


def _heads(idx: np.ndarray) -> np.ndarray:
    """The change bitmask of ``tc_prep_kernel``: bit c of word c // 32 is
    set when chunk c (positions 32c .. 32c + 31) holds a position whose
    index differs from the one before it."""
    e = len(idx)
    words = np.zeros(fg.heads_words(e), dtype=np.uint32)
    change = np.zeros(e, dtype=bool)
    change[1:] = idx[1:] != idx[:-1]
    for p in np.flatnonzero(change):
        c = p // 32
        words[c // 32] |= np.uint32(1 << (c % 32))
    return words.view(I32)


def _read(ptr, shape, dtype):
    """A fresh copy of the array at ``ptr``: every operand the stand-ins
    compute on is a new allocation (64-byte aligned), so their products do
    not depend on where the wrapper's buffers lie."""
    return _dense(ptr, shape, dtype).clone()


def _mm(a, b):
    """``a @ b`` on fresh contiguous copies of both operands: the same
    operands give the same bits whatever views they came as."""
    return a.contiguous().clone() @ b.contiguous().clone()


def _row_ptr(keys: np.ndarray, n: int) -> np.ndarray:
    """CSR offsets of sorted ``keys`` over ``n`` rows, as int32."""
    if not len(keys):
        return np.zeros(n + 1, dtype=I32)
    return np.searchsorted(keys, np.arange(n + 1), side="left").astype(I32)


def _segment_sum(src, idx, row_ptr, n):
    """Per row, the in-order sum of src[idx[e]] over its segment."""
    out = src.new_zeros((n, src.shape[1]))
    keys = torch.repeat_interleave(torch.arange(n),
                                   (row_ptr[1:] - row_ptr[:-1]).long())
    return out.index_add_(0, keys, src[idx.long()])


def _gates(agg, h, xw, xb, hw, hb):
    xr, xz, xn = (_mm(agg, xw) + xb).chunk(3, dim=-1)
    hr, hz, hn = (_mm(h, hw) + hb).chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    return r, z, torch.tanh(xn + r * hn), hn


# What each kernel computes, on tensors: the stand-ins call these on the
# arrays behind the wrapper's addresses, and `_chain` calls them directly.

def _linear_t(a, w, b=None):
    y = _mm(a, w)
    return y + b if b is not None else y


def _round_t(h, msg, row_ptr, snd, w4):
    """One forward round: ``(h', agg)``."""
    agg = _segment_sum(msg, snd, row_ptr, h.shape[0])
    _, z, ng, _ = _gates(agg, h, *w4)
    return (1.0 - z) * ng + z * h, agg


def _gate_t(h, agg, g, w4):
    """The reverse round's chain: ``(dxp, dhp, g z)``."""
    r, z, ng, hn = _gates(agg, h, *w4)
    dz = g * (h - ng)
    dpre_n = g * (1.0 - z) * (1.0 - ng * ng)
    dpre_r = dpre_n * hn * r * (1.0 - r)
    dpre_z = dz * z * (1.0 - z)
    return (torch.cat([dpre_r, dpre_z, dpre_n], 1),
            torch.cat([dpre_r, dpre_z, dpre_n * r], 1), g * z)


def _chunks(n):
    return -(-n // 512)


def _wgrad_rows(agg, dxp, h, dhp, dmsg):
    """Per 512-node chunk, the weight gradients' partial row
    ``[dxw | dxb | dhw | dhb | dew | deb]``."""
    rows = []
    for c in range(_chunks(h.shape[0])):
        s = slice(512 * c, 512 * c + 512)
        rows.append(torch.cat([
            _mm(agg[s].t(), dxp[s]).reshape(-1), dxp[s].sum(0),
            _mm(h[s].t(), dhp[s]).reshape(-1), dhp[s].sum(0),
            _mm(h[s].t(), dmsg[s]).reshape(-1), dmsg[s].sum(0)]))
    return torch.stack(rows)


def _reduce_t(part):
    s = part[0].clone()
    for c in range(1, part.shape[0]):
        s = s + part[c]
    return s


class _StandIn:
    """Stands in for both built libraries on CPU memory. Each entry point
    records its name and node count; with ``compute`` it reads its
    arguments through their addresses and writes what its kernel writes.
    A ``code`` other than 0 is returned from ``fail_at`` on."""

    def __init__(self, d, compute=True, code=0, fail_at=None):
        self.d, self.compute, self.code = d, compute, code
        self.fail_at = fail_at
        self.calls = []
        self.widths = []  # (entry, width) of every tensor-core entry
        self.weights = {}  # the last weights a tensor-core entry was given

    def _call(self, name, n, d=None):
        self.calls.append((name, n))
        if d is not None:
            self.widths.append((name, d))
        if self.code and (self.fail_at is None or name == self.fail_at):
            return self.code
        return 0

    # ---- shared shapes
    def _w(self, xw, xb, hw, hb, d):
        return (_read(xw, (d, 3 * d), F32), _read(xb, (3 * d,), F32),
                _read(hw, (d, 3 * d), F32), _read(hb, (3 * d,), F32))

    # ---- forward
    def _prep(self, keys, idx, e, n, row_ptr, heads):
        k = _read(keys, (e,), I32).numpy() if e else np.zeros(0, I32)
        _dense(row_ptr, (n + 1,), I32)[:] = torch.from_numpy(_row_ptr(k, n))
        if heads is not None and e:
            words = _heads(_read(idx, (e,), I32).numpy())
            _dense(heads, (len(words),), I32)[:] = torch.from_numpy(words)

    def ggnn_tc_prep(self, rcv, snd, e, n, row_ptr, heads, d, stream):
        code = self._call("tc_prep", n, d)
        if self.compute and not code:
            self._prep(rcv, snd, e, n, row_ptr, heads)
        return code

    def ggnn_csr(self, rcv, e, n, row_ptr, stream):
        code = self._call("csr", n)
        if self.compute and not code:
            self._prep(rcv, None, e, n, row_ptr, None)
        return code

    def _linear(self, a, w, b, out, n, din, dout, acc=0):
        y = _linear_t(_read(a, (n, din), F32), _read(w, (din, dout), F32),
                      _read(b, (dout,), F32) if b else None)
        o = _dense(out, (n, dout), F32)
        o[:] = o + y if acc else y

    def ggnn_tc_linear(self, a, w, b, row_ptr, snd, heads, flags, out, n, d,
                       stream):
        code = self._call("tc_linear", n, d)
        self.weights["ew"] = _read(w, (d, d), F32)
        if self.compute and not code:
            self._linear(a, w, b, out, n, d, d)
        return code

    def ggnn_linear(self, a, w, b, out, n, din, dout, stream):
        code = self._call("linear", n)
        if self.compute and not code:
            self._linear(a, w, b, out, n, din, dout)
        return code

    def _round(self, h, msg, row_ptr, snd, xw, xb, hw, hb, h_out, agg_bank,
               n, d):
        rp = _read(row_ptr, (n + 1,), I32)
        e = int(rp[n])
        idx = _read(snd, (e,), I32) if e else torch.zeros(0, dtype=torch.int32)
        h_new, agg = _round_t(_read(h, (n, d), F32), _read(msg, (n, d), F32),
                              rp, idx, self._w(xw, xb, hw, hb, d))
        _dense(h_out, (n, d), F32)[:] = h_new
        if agg_bank:
            _dense(agg_bank, (n, d), F32)[:] = agg

    def ggnn_tc_round(self, h, msg, row_ptr, snd, heads, flags, xw, xb, hw,
                      hb, h_out, agg_bank, n, d, stream):
        code = self._call("tc_round", n, d)
        self.weights.update(zip(("xw", "xb", "hw", "hb"),
                                self._w(xw, xb, hw, hb, d)))
        if self.compute and not code:
            self._round(h, msg, row_ptr, snd, xw, xb, hw, hb, h_out,
                        agg_bank, n, d)
        return code

    def ggnn_gru_round(self, h, msg, row_ptr, snd, xw, xb, hw, hb, h_out,
                       agg_bank, n, d, stream):
        code = self._call("gru_round", n)
        if self.compute and not code:
            self._round(h, msg, row_ptr, snd, xw, xb, hw, hb, h_out,
                        agg_bank, n, d)
        return code

    # ---- backward
    def ggnn_bwd_tc_prep(self, snd, rcv, e, n, csc_ptr, heads, stream):
        code = self._call("bwd_tc_prep", n)
        if self.compute and not code:
            self._prep(snd, rcv, e, n, csc_ptr, heads)
        return code

    def ggnn_bwd_csc(self, snd, e, n, csc_ptr, stream):
        code = self._call("bwd_csc", n)
        if self.compute and not code:
            self._prep(snd, None, e, n, csc_ptr, None)
        return code

    def _gate(self, h, agg, g, xw, xb, hw, hb, n, d):
        return _gate_t(*(_read(p, (n, d), F32) for p in (h, agg, g)),
                       self._w(xw, xb, hw, hb, d))

    def ggnn_bwd_tc_gate(self, h, agg, g, xw, xb, hw, hb, dxp, dhn, dagg,
                         dh_out, n, d, stream):
        code = self._call("bwd_tc_gate", n, d)
        if self.compute and not code:
            x, hp, gz = self._gate(h, agg, g, xw, xb, hw, hb, n, d)
            _dense(dxp, (n, 3 * d), F32)[:] = x
            _dense(dhn, (n, d), F32)[:] = hp[:, 2 * d:]
            _dense(dagg, (n, d), F32)[:] = _mm(
                x, _read(xw, (d, 3 * d), F32).t())
            _dense(dh_out, (n, d), F32)[:] = gz + _mm(
                hp, _read(hw, (d, 3 * d), F32).t())
        return code

    def ggnn_bwd_gate(self, h, agg, g, xw, xb, hw, hb, dxp, dhp, dh_out, n,
                      d, stream):
        code = self._call("bwd_gate", n)
        if self.compute and not code:
            x, hp, gz = self._gate(h, agg, g, xw, xb, hw, hb, n, d)
            _dense(dxp, (n, 3 * d), F32)[:] = x
            _dense(dhp, (n, 3 * d), F32)[:] = hp
            _dense(dh_out, (n, d), F32)[:] = gz
        return code

    def ggnn_bwd_linear(self, a, w, out, n, din, dout, acc, stream):
        code = self._call("bwd_linear", n)
        if self.compute and not code:
            self._linear(a, w, None, out, n, din, dout, acc)
        return code

    def _tsum(self, dagg, csc_ptr, csc_rcv, dmsg, n, d):
        cp = _read(csc_ptr, (n + 1,), I32)
        e = int(cp[n])
        _dense(dmsg, (n, d), F32)[:] = _segment_sum(
            _read(dagg, (n, d), F32),
            _read(csc_rcv, (e,), I32) if e else
            torch.zeros(0, dtype=torch.int32), cp, n)

    def ggnn_bwd_tc_tsum(self, dagg, csc_ptr, csc_rcv, heads, ew, dmsg, dh,
                         n, d, stream):
        code = self._call("bwd_tc_tsum", n, d)
        if self.compute and not code:
            self._tsum(dagg, csc_ptr, csc_rcv, dmsg, n, d)
            o = _dense(dh, (n, d), F32)
            o[:] = o + _mm(_read(dmsg, (n, d), F32),
                           _read(ew, (d, d), F32).t())
        return code

    def ggnn_bwd_transpose_sum(self, dagg, csc_ptr, csc_rcv, dmsg, n, d,
                               stream):
        code = self._call("bwd_transpose_sum", n)
        if self.compute and not code:
            self._tsum(dagg, csc_ptr, csc_rcv, dmsg, n, d)
        return code

    @staticmethod
    def ggnn_bwd_chunks(n):
        return _chunks(n)

    @staticmethod
    def ggnn_bwd_partial_width(d):
        return 2 * (d * 3 * d + 3 * d) + d * d + d

    def _wgrad(self, agg, dxp, h, dhp, dmsg, part, n, d, acc, dhp_width):
        bx = _read(dxp, (n, 3 * d), F32)
        bh = _read(dhp, (n, dhp_width), F32)
        if dhp_width == d:  # the tensor-core kernels' dhn: dhp's last block
            bh = torch.cat([bx[:, :2 * d], bh], 1)
        rows = _wgrad_rows(_read(agg, (n, d), F32), bx, _read(h, (n, d), F32),
                           bh, _read(dmsg, (n, d), F32))
        out = _dense(part, (_chunks(n), self.ggnn_bwd_partial_width(d)), F32)
        out[:] = out + rows if acc else rows

    def ggnn_bwd_tc_wgrad(self, agg, dxp, h, dhn, dmsg, part, n, d, acc,
                          stream):
        code = self._call("bwd_tc_wgrad", n, d)
        if self.compute and not code:
            self._wgrad(agg, dxp, h, dhn, dmsg, part, n, d, acc, d)
        return code

    def ggnn_bwd_wgrad(self, agg, dxp, h, dhp, dmsg, part, n, d, acc,
                       stream):
        code = self._call("bwd_wgrad", n)
        if self.compute and not code:
            self._wgrad(agg, dxp, h, dhp, dmsg, part, n, d, acc, 3 * d)
        return code

    def ggnn_bwd_reduce(self, part, chunks, ld, out, stream):
        code = self._call("bwd_reduce", chunks)
        if self.compute and not code:
            _dense(out, (ld,), F32)[:] = _reduce_t(
                _read(part, (chunks, ld), F32))
        return code

    @staticmethod
    def ggnn_error_string(code):
        return b"an illegal memory access was encountered"


def _chain(h0, snd, rcv, weights, n_steps, g):
    """The stand-ins' functions called directly on the call's tensors, in
    the order the wrapper launches them, with none of its buffers, banks or
    addresses: ``(out, dh0, dew, deb, dxw, dxb, dhw, dhb)``."""
    n, d = h0.shape
    ew, eb, xw, xb, hw, hb = weights
    w4 = (xw, xb, hw, hb)
    rp = torch.from_numpy(_row_ptr(rcv.numpy(), n))
    h, hs, aggs = h0, [], []
    for _ in range(n_steps):
        msg = _linear_t(h, ew, eb)
        hs.append(h)
        h, agg = _round_t(h, msg, rp, snd, w4)
        aggs.append(agg)
    out = h
    order = np.argsort(snd.numpy(), kind="stable")
    cp = torch.from_numpy(_row_ptr(snd.numpy()[order], n))
    csc_rcv = rcv[torch.from_numpy(order)]
    dh, part = g, None
    for t in reversed(range(n_steps)):
        dxp, dhp, gz = _gate_t(hs[t], aggs[t], dh, w4)
        dagg = _mm(dxp, xw.t())
        dh_next = gz + _mm(dhp, hw.t())
        dmsg = _segment_sum(dagg, csc_rcv, cp, n)
        dh = dh_next + _mm(dmsg, ew.t())
        rows = _wgrad_rows(aggs[t], dxp, hs[t], dhp, dmsg)
        part = rows if part is None else part + rows
    dxw, dxb, dhw, dhb, dew, deb = _reduce_t(part).split(
        [d * 3 * d, 3 * d, d * 3 * d, 3 * d, d * d, d])
    return (out, dh, dew.view(d, d), deb, dxw.view(d, 3 * d), dxb,
            dhw.view(d, 3 * d), dhb)


U = 2.0 ** -24  # float32's unit roundoff


def _gamma(k):
    """Higham's gamma_k = k u / (1 - k u): a float32 sum of k + 1 terms, in
    any order, is within gamma_k of the sum of their absolute values."""
    return k * U / (1 - k * U)


def _tolerances(h0, snd, rcv, weights, n_steps, g):
    """Per element of ``(out, dh0, dew, deb, dxw, dxb, dhw, dhb)``: gamma_k
    times the sum of absolute terms of the last sum that makes it, from a
    float64 run of the plain version.

    - ``out``: the last round's pre-activations, whose errors pass through
      sigmoid and tanh with a gain of at most 1; for column j the largest
      over its three gate columns of ``|agg| |xw| + |xb| + |h| |hw| + |hb|
      + (edge sum of |msg|) |xw|``, with k = d + 1 + the largest in-degree
      (the edge sum, then the product).
    - ``dh0``: the first round's ``|g z| + |dhp| |hw|^T + |dmsg| |ew|^T +
      (edge sum of |dagg|) |ew|^T``, with k = 3d + 1 + the largest
      out-degree.
    - the weight gradients: the sum over every row of every round of
      ``|a|^T |b|`` (``|b|`` for the biases), with k = n n_steps + the
      512-node chunks.

    That is the room a single float32 evaluation of each last sum may
    take, in any order, and it scales with the terms, not with the
    largest result, so a gradient whose terms cancel gets the room its
    terms need.
    """
    A = torch.abs
    n, d = h0.shape
    ew, eb, xw, xb, hw, hb = (w.double() for w in weights)
    snd, rcv = snd.long(), rcv.long()
    seg = lambda x, to, fr: x.new_zeros((n, x.shape[1])).index_add_(
        0, to, x.index_select(0, fr))
    h, hs, aggs = h0.double(), [], []
    for _ in range(n_steps):
        hs.append(h)
        aggs.append(seg(h @ ew + eb, rcv, snd))
        _, z, ng, _ = fg._gru(aggs[-1], h, xw, xb, hw, hb)
        h = (1.0 - z) * ng + z * h
    h, agg = hs[-1], aggs[-1]
    pre = (A(agg) @ A(xw) + A(xb) + A(h) @ A(hw) + A(hb)
           + seg(A(h @ ew + eb), rcv, snd) @ A(xw))
    out = pre.view(n, 3, d).amax(1)
    dh = g.double()
    names = ("ew", "eb", "xw", "xb", "hw", "hb")
    terms = dict.fromkeys(names, 0.0)
    for t in reversed(range(n_steps)):
        h, agg = hs[t], aggs[t]
        r, z, ng, hn = fg._gru(agg, h, xw, xb, hw, hb)
        dz, dn = dh * (h - ng), dh * (1.0 - z)
        dpn = dn * (1.0 - ng * ng)
        dpr, dpz = dpn * hn * r * (1.0 - r), dz * z * (1.0 - z)
        dxp = torch.cat([dpr, dpz, dpn], 1)
        dhp = torch.cat([dpr, dpz, dpn * r], 1)
        dagg = dxp @ xw.t()
        dmsg = seg(dagg, snd, rcv)
        dh0 = (A(dh * z) + A(dhp) @ A(hw).t() + A(dmsg) @ A(ew).t()
               + seg(A(dagg), snd, rcv) @ A(ew).t())
        dh = dh * z + dhp @ hw.t() + dmsg @ ew.t()
        for k, (a, b) in {"xw": (agg, dxp), "hw": (h, dhp),
                          "ew": (h, dmsg)}.items():
            terms[k] = terms[k] + A(a).t() @ A(b)
        for k, b in {"xb": dxp, "hb": dhp, "eb": dmsg}.items():
            terms[k] = terms[k] + A(b).sum(0)
    deg_in = int(torch.bincount(rcv, minlength=n).max())
    deg_out = int(torch.bincount(snd, minlength=n).max())
    gw = _gamma(n * n_steps + _chunks(n))
    return ((_gamma(d + 1 + deg_in) * out, _gamma(3 * d + 1 + deg_out) * dh0)
            + tuple(gw * terms[k] for k in names))


@pytest.fixture
def lib(monkeypatch):
    def install(d=128, **kw):
        stand_in = _StandIn(d, **kw)
        monkeypatch.setattr(fg, "_fwd", stand_in)
        monkeypatch.setattr(fg, "_bwd", stand_in)
        return stand_in

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    for name in ("n_variant_launches", "n_bwd_variant_launches"):
        monkeypatch.setattr(fg, name, dict.fromkeys(fg.VARIANTS, 0))
    monkeypatch.setattr(fg, "n_launches", 0)
    monkeypatch.setattr(fg, "n_bwd_launches", 0)
    # one intra-op thread: a product then takes one summation order, so the
    # stand-ins and `_chain` agree bit for bit on the same operands
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield install
    torch.set_num_threads(threads)


def _graph(n, e, d, seed=0, sink_loops=0):
    """Receiver-sorted random edges among the first nodes, ``sink_loops``
    padding edges sink -> sink (batch_np's padding), and seeded weights in
    the ``[in, out]`` layout."""
    rng = np.random.default_rng(seed)
    snd = rng.integers(0, n - 1, e)
    rcv = np.sort(rng.integers(0, n - 1, e))
    snd = np.concatenate([snd, np.full(sink_loops, n - 1)]).astype(np.int32)
    rcv = np.concatenate([rcv, np.full(sink_loops, n - 1)]).astype(np.int32)
    f = lambda *s, std: torch.from_numpy(
        (rng.standard_normal(s) * std).astype(F32))
    weights = (f(d, d, std=d ** -0.5), f(d, std=0.1),
               f(d, 3 * d, std=d ** -0.5), f(3 * d, std=0.1),
               f(d, 3 * d, std=d ** -0.5), f(3 * d, std=0.1))
    return (f(n, d, std=0.2), torch.from_numpy(snd), torch.from_numpy(rcv),
            weights)


def _names(stand_in):
    return [name for name, _ in stand_in.calls]


@pytest.mark.parametrize("n", MAIN_PATH_NODES)
def test_main_path_buckets_reach_the_tensor_core_entries(lib, n):
    stand_in = lib(compute=False)
    h0, snd, rcv, weights = _graph(n, 2 * n, 128, sink_loops=n // 4)
    p = fg._Prepared(h0, snd, rcv, weights, 1024)
    assert p.variant == "wgmma"
    _, states, aggs = fg._forward_cuda(p, 5, bank=True)
    fg._backward_cuda(p, states, aggs, torch.zeros(n, 128))
    assert _names(stand_in) == (
        ["tc_prep"] + ["tc_linear", "tc_round"] * 5 + ["bwd_tc_prep"]
        + ["bwd_tc_gate", "bwd_tc_tsum", "bwd_tc_wgrad"] * 5
        + ["bwd_reduce"])
    assert all(k == n for name, k in stand_in.calls if name != "bwd_reduce")
    assert fg.n_variant_launches == {"wgmma": fg.launches_per_call(5),
                                     "ffma": 0}
    assert fg.n_bwd_variant_launches == {
        "wgmma": fg.bwd_launches_per_call(5), "ffma": 0}
    assert (fg.n_launches, fg.n_bwd_launches) == (11, 17)


@pytest.mark.parametrize("d,kind", [(128, "wgmma"), (125, "wgmma"),
                                    (124, "ffma"), (132, "ffma"),
                                    (32, "ffma"), (6, "ffma"),
                                    (192, "wgmma"), (221, "wgmma"),
                                    (224, "wgmma"), (288, "wgmma"),
                                    (160, "ffma"), (256, "ffma"),
                                    (292, "ffma")])
def test_variant_follows_the_padded_width(d, kind):
    assert fg.variant(d) == kind


@pytest.mark.parametrize("d,dp", [(192, 192), (221, 224), (224, 224),
                                  (288, 288)])
def test_family_widths_reach_the_tensor_core_entries(lib, d, dp):
    """The analysis families' widths (and 221, padded to 224) take every
    tensor-core entry, forward and backward, each given the padded width,
    and the weights the kernels read are the call's padded per gate: each
    r|z|n block of xw and hw holds the call's block in its first d rows
    and columns and zeros elsewhere."""
    stand_in = lib(d=dp, compute=False)
    n = 5760
    h0, snd, rcv, weights = _graph(n, 2 * n, d, sink_loops=300)
    p = fg._Prepared(h0, snd, rcv, weights, 1024)
    assert (p.variant, p.dp) == ("wgmma", dp)
    _, states, aggs = fg._forward_cuda(p, 5, bank=True)
    fg._backward_cuda(p, states, aggs, torch.zeros(n, d))
    assert _names(stand_in) == (
        ["tc_prep"] + ["tc_linear", "tc_round"] * 5 + ["bwd_tc_prep"]
        + ["bwd_tc_gate", "bwd_tc_tsum", "bwd_tc_wgrad"] * 5
        + ["bwd_reduce"])
    assert {w for _, w in stand_in.widths} == {dp}
    assert [name for name, _ in stand_in.widths] == [
        name for name in _names(stand_in)
        if name not in ("bwd_tc_prep", "bwd_reduce")]
    ew, eb, xw, xb, hw, hb = weights
    seen = stand_in.weights
    pad = torch.zeros(dp, dp)
    pad[:d, :d] = ew
    assert torch.equal(seen["ew"], pad)
    for name, w in (("xw", xw), ("hw", hw)):
        got = seen[name].reshape(dp, 3, dp)
        want = torch.zeros(dp, 3, dp)
        want[:d, :, :d] = w.reshape(d, 3, d)
        assert torch.equal(got, want), name
    for name, b in (("xb", xb), ("hb", hb)):
        want = torch.zeros(3, dp)
        want[:, :d] = b.reshape(3, d)
        assert torch.equal(seen[name].reshape(3, dp), want), name
    assert fg.n_variant_launches == {"wgmma": fg.launches_per_call(5),
                                     "ffma": 0}
    assert fg.n_bwd_variant_launches == {
        "wgmma": fg.bwd_launches_per_call(5), "ffma": 0}


@pytest.mark.parametrize("d", [32, 132])
def test_other_widths_reach_the_ffma_entries(lib, d):
    stand_in = lib(d=d, compute=False)
    h0, snd, rcv, weights = _graph(64, 100, d)
    p = fg._Prepared(h0, snd, rcv, weights, 1024)
    _, states, aggs = fg._forward_cuda(p, 2, bank=True)
    fg._backward_cuda(p, states, aggs, torch.zeros(64, d))
    assert _names(stand_in) == (
        ["csr"] + ["linear", "gru_round"] * 2 + ["bwd_csc"]
        + ["bwd_gate", "bwd_linear", "bwd_linear", "bwd_transpose_sum",
           "bwd_linear", "bwd_wgrad"] * 2 + ["bwd_reduce"])
    assert fg.n_variant_launches == {"wgmma": 0,
                                     "ffma": fg.launches_per_call(2)}
    assert fg.n_bwd_variant_launches == {
        "wgmma": 0, "ffma": fg.bwd_launches_per_call(2, "ffma")}


def test_the_wgmma_variant_refuses_another_width(lib):
    lib(d=32, compute=False)
    h0, snd, rcv, weights = _graph(64, 100, 32)
    p = fg._Prepared(h0, snd, rcv, weights, 1024)
    with pytest.raises(ValueError, match="takes widths"):
        fg._forward_cuda(p, 2, bank=False, kind="wgmma")


@pytest.mark.parametrize("entry,d", [
    pytest.param(e, d, id=e if d == 128 else f"{e}-{d}")
    for d in (128, 224) for e in ("tc_prep", "tc_linear", "tc_round")])
def test_a_failed_forward_launch_raises(lib, entry, d):
    lib(d=d, compute=False, code=700, fail_at=entry)
    h0, snd, rcv, weights = _graph(256, 512, d)
    p = fg._Prepared(h0, snd, rcv, weights, 1024)
    with pytest.raises(RuntimeError, match=f"{entry} launch failed"):
        fg._forward_cuda(p, 2, bank=False)


@pytest.mark.parametrize("entry,d", [
    pytest.param(e, d, id=e if d == 128 else f"{e}-{d}")
    for d in (128, 224) for e in ("bwd_tc_prep", "bwd_tc_gate",
                                  "bwd_tc_tsum", "bwd_tc_wgrad",
                                  "bwd_reduce")])
def test_a_failed_backward_launch_raises(lib, entry, d):
    stand_in = lib(d=d, compute=False)
    h0, snd, rcv, weights = _graph(256, 512, d)
    p = fg._Prepared(h0, snd, rcv, weights, 1024)
    _, states, aggs = fg._forward_cuda(p, 2, bank=True)
    stand_in.code, stand_in.fail_at = 700, entry
    with pytest.raises(RuntimeError, match="launch failed"):
        fg._backward_cuda(p, states, aggs, torch.zeros(256, d))


@pytest.mark.parametrize("d", [128, 32, 224, 288])
def test_the_wrapper_computes_the_plain_version(lib, d):
    """Buffers, banks, ping-pong and argument order: the stand-ins write
    what each kernel computes, and the wrapper's forward and backward
    equal bit for bit the stand-ins' functions chained directly on the
    call's tensors (`_chain`). The same chain in float64 equals the plain
    versions in float64 within `_tolerances`: the room float32 summation
    may take in each result's last sum. Both float64 runs evaluate one
    function and differ only in their orders of summation, by some 1e-16
    of the terms times the chain's gain; the gain of this graph's chain
    (its sink's 70 self-loops feed three rounds) stays below 1e5, so the
    float64 runs agree far inside that room, while a misrouted term or a
    wrong formula is off by the order of the terms themselves."""
    lib(d=d)
    n, steps = 300, 3
    h0, snd, rcv, weights = _graph(n, 900, d, sink_loops=70)
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (n, d)).astype(F32) * 1e-2)
    p = fg._Prepared(h0, snd, rcv, weights, 1024)
    out, states, aggs = fg._forward_cuda(p, steps, bank=True)
    ping, _, _ = fg._forward_cuda(p, steps, bank=False)
    assert torch.equal(ping, out), (
        f"ping-pong differs by {float((ping - out).abs().max())}")
    got = (out,) + fg._backward_cuda(p, states, aggs, g)
    names = ("out", "dh0", "dew", "deb", "dxw", "dxb", "dhw", "dhb")
    for name, a, c in zip(names, got, _chain(h0, snd, rcv, weights, steps,
                                             g)):
        assert a.shape == c.shape and torch.equal(a, c), (
            f"{name}: differs from the chained stand-ins by "
            f"{float((a - c).abs().max())}")
    wide = (h0.double(), snd, rcv, tuple(w.double() for w in weights))
    chained = _chain(*wide, steps, g.double())
    ref = (fg.fused_ggnn_reference(*wide[:3], *wide[3], n_steps=steps),)
    ref += fg.fused_ggnn_backward_reference(*wide[:3], *wide[3], g.double(),
                                            n_steps=steps)
    for name, c, r, tol in zip(names, chained, ref,
                               _tolerances(h0, snd, rcv, weights, steps, g)):
        assert c.dtype == r.dtype == torch.float64
        err = (c - r).abs()
        worst = int((err / tol).argmax())
        assert bool((err <= tol).all()), (
            f"{name}: error {float(err.flatten()[worst])} over its room "
            f"{float(tol.flatten()[worst])}")


class _MegaStandIn(_StandIn):
    """B3's entry points on the same stand-in: only the calls are
    recorded, and the width each tensor-core entry is given (its argument
    before the stream)."""

    def __getattr__(self, name):
        if not name.startswith("mb_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, None))
            if name.startswith("mb_tc_"):
                self.widths.append((name, args[-2]))
            return 0
        return entry


@pytest.mark.parametrize("d,rounds", [(128, ["mb_tc_linear", "mb_tc_round"]),
                                      (32, ["mb_linear", "mb_gru_round"]),
                                      (224, ["mb_tc_linear", "mb_tc_round"])])
def test_megabatch_rounds_take_the_width_s_variant(monkeypatch, d, rounds):
    stand_in = _MegaStandIn(d, compute=False)
    monkeypatch.setattr(mb, "n_variant_launches", dict.fromkeys(fg.VARIANTS,
                                                                0))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    p = types.SimpleNamespace(
        buf={k: torch.zeros(4, dtype=torch.int32) for k in (
            "h0", "row_ptr", "graph_ptr", "senders", "heads", "flags", "ids",
            "receivers", "gidx", "h_a", "h_b", "msg", "mask", "gate", "out")},
        n=64, d=d, e=100, g=2, n_sub=4, ed=d // 4, n_steps=5,
        dims=[2 * d, 1], table=torch.zeros(4),
        weights=[torch.zeros(1)] * 9)
    monkeypatch.setattr(mb, "_lib", stand_in)
    mb._launch(p)
    prep = "mb_tc_prep" if fg.variant(d) == "wgmma" else "mb_csr"
    assert _names(stand_in) == (["mb_embed", prep, "mb_csr"] + rounds * 5
                                + ["mb_pool_head"])
    kind = fg.variant(d)
    assert mb.n_variant_launches[kind] == mb.launches_per_call(5)
    tc = [name for name in _names(stand_in) if name.startswith("mb_tc_")]
    assert stand_in.widths == [(name, d) for name in tc]


# ------------------------------------------------------------ 3xTF32 split


def tf32_rna(x: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32`` on finite float32 values: round the magnitude
    to 10 explicit mantissa bits, ties away from zero, low 13 bits zero."""
    bits = np.asarray(x, dtype=F32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(F32)


def split(x: np.ndarray):
    big = tf32_rna(x)
    return big, tf32_rna((x - big).astype(F32))


def test_the_split_is_within_2_pow_minus_22():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(200_000)
         * 10.0 ** rng.uniform(-30, 30, 200_000)).astype(F32)
    big, small = split(x)
    assert np.all(big.view(np.uint32) & 0x1FFF == 0)
    assert np.all(small.view(np.uint32) & 0x1FFF == 0)
    err = np.abs(big.astype(np.float64) + small - x.astype(np.float64))
    assert np.all(err <= 2.0 ** -22 * np.abs(x.astype(np.float64)))


@pytest.mark.parametrize("k", [128, 384])
def test_three_products_keep_float32_accuracy(k):
    rng = np.random.default_rng(k)
    a = rng.standard_normal((64, k)).astype(F32)
    b = (rng.standard_normal((k, 96)) * k ** -0.5).astype(F32)
    (ab, as_), (bb, bs) = split(a), split(b)
    f64 = lambda t: t.astype(np.float64)
    got = f64(as_) @ f64(bb) + f64(ab) @ f64(bs) + f64(ab) @ f64(bb)
    exact = f64(a) @ f64(b)
    assert np.abs(got - exact).max() <= 1e-6 * np.abs(exact).max()


# ------------------------------------------------- the edge sum's closed form


def _bits(v) -> int:
    return int(np.asarray(v, dtype=F32).view(np.uint32))


def _float(b: int) -> np.float32:
    return np.asarray(b, dtype=np.uint32).view(F32)[()]


def repeat_add(acc, x, k: int, counts=None) -> np.float32:
    """Mirror of ``repeat_add`` in ``csrc/ggnn_tc.cuh``, step for step;
    appends the number of loop steps to ``counts`` when given."""
    acc, x = F32(acc), F32(x)
    if k <= 0:
        return acc
    xb, ab = _bits(x), _bits(acc)
    xm, am = xb & 0x7FFFFFFF, ab & 0x7FFFFFFF
    if xm == 0:
        return F32(acc + x)
    if xm >= 0x7F800000 or am >= 0x7F800000 or (am != 0 and (ab ^ xb) >> 31):
        for _ in range(k):
            acc = F32(acc + x)
        return acc
    y = _float(xm)
    ey = max(xm >> 23, 1)
    yq = xm - ((ey - 1) << 23)
    a = _float(am)
    n_loop = 0
    while k > 0:
        n_loop += 1
        bits = _bits(a)
        if bits >= 0x7F800000:
            break
        e = max(bits >> 23, 1)
        aq = bits - ((e - 1) << 23)
        sh = e - ey
        if sh >= 25:
            break
        if bits == 0 or sh < 0:
            a, k = F32(a + y), k - 1
            continue
        if sh == 0:
            q = inc = yq
        else:
            q = yq >> sh
            rem, half = yq & ((1 << sh) - 1), 1 << (sh - 1)
            if rem < half:
                inc = q
            elif rem > half:
                inc = q + 1
            elif aq & 1:
                a, k = F32(a + y), k - 1
                continue
            else:
                inc = q + (q & 1)
        if inc == 0:
            break
        last = 0xFFFFFF - q
        if aq <= last:
            t = min((last - aq) // inc + 1, k)
            a = _float(((e - 1) << 23) + aq + t * inc)
            k -= t
        if k > 0:
            a, k = F32(a + y), k - 1
    if counts is not None:
        counts.append(n_loop)
    return _float(_bits(a) | (xb & 0x80000000))


def serial(acc: np.ndarray, x: np.ndarray, k: np.ndarray) -> np.ndarray:
    """The serial float32 chain for many cases at once."""
    acc = acc.astype(F32).copy()
    x = x.astype(F32)
    for i in range(int(k.max())):
        live = i < k
        acc[live] = (acc[live] + x[live]).astype(F32)
    return acc


def _cases(rng, m, start):
    x = (rng.standard_normal(m) * 10.0 ** rng.uniform(-8, 8, m)).astype(F32)
    k = rng.integers(1, 2 ** 15 + 1, m)
    if start == "zero":
        acc = np.zeros(m, F32)
    elif start == "same":
        acc = (np.abs(rng.standard_normal(m)) * 10.0 ** rng.uniform(-8, 8, m)
               * np.sign(x)).astype(F32)
    else:  # the other sign: the chain runs
        acc = (-np.abs(rng.standard_normal(m)) * np.abs(x) * k / 3
               * np.sign(x)).astype(F32)
    return acc, x, k


@pytest.mark.parametrize("start", ["zero", "same", "other"])
def test_closed_form_equals_the_serial_chain(start):
    rng = np.random.default_rng({"zero": 0, "same": 1, "other": 2}[start])
    acc, x, k = _cases(rng, 300, start)
    want = serial(acc, x, k)
    got = np.array([repeat_add(a, v, int(n)) for a, v, n in zip(acc, x, k)],
                   dtype=F32)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_closed_form_on_zero_rows_and_edge_values():
    tiny = _float(1)  # the smallest subnormal
    big = F32(3e38)
    acc = np.array([0.0, 5.0, -0.0, -0.0, 0.0, 1e-40, 0.0, 2.0 ** 120, 1.0,
                    -3.0, 0.0, 1.0], F32)
    x = np.array([0.0, 0.0, 0.0, -0.0, tiny, tiny, big, big, 2.0 ** -24,
                  -2.0 ** -23, 1.0, 1.5 * 2.0 ** -24], F32)
    k = np.array([17114, 3, 5, 5, 30000, 20000, 7, 9, 5000, 7000, 32768,
                  4099])
    want = serial(acc, x, k)
    got = np.array([repeat_add(a, v, int(n)) for a, v, n in zip(acc, x, k)],
                   dtype=F32)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    # a zero row leaves the accumulator as it was (the padding sink's zero
    # cotangent in the backward)
    assert _bits(repeat_add(F32(5.0), F32(0.0), 17114)) == _bits(F32(5.0))


def test_closed_form_takes_a_few_steps_a_binade():
    """The sink's run at the megabatch shape (17,114 equal senders) from
    zero, and the longest runs of the other starts: a few loop steps a
    binade of the accumulator, bit for bit the chain."""
    rng = np.random.default_rng(3)
    counts = []
    for start, kmax in (("zero", 17114), ("same", 2 ** 15)):
        acc, x, _ = _cases(rng, 64, start)
        k = np.full(64, kmax)
        want = serial(acc, x, k)
        for a, v, w in zip(acc, x, want):
            got = repeat_add(a, v, kmax, counts)
            assert _bits(got) == _bits(w)
    assert max(counts) <= 40
