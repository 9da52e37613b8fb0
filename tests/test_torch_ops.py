"""Kernel rows 1-11 as ``torch.library`` operators, and the routes traced
through them by torch.export and torch.compile.

* opcheck: ``torch.library.opcheck`` (schema, autograd registration, the
  fake implementation against the CPU one, AOT dispatch with dynamic
  shapes) on each operator, at the operands the loss routes give it on
  the CPU (B=2, T=6, S1=4, V=5, from a seeded RandomState), f32 and, where
  the row takes the logits, bf16.
* fake trace: each kernel route under FakeTensorMode on fake ``cuda``
  tensors, with warnings as errors: the outputs' shapes and dtypes, no
  launch counted and no kernel library loaded. A route that read a fake
  tensor's data pointer (a ctypes call while tracing) fails here.
* exported graphs: ``serving.export_fn`` over each route holds the
  expected ``mrnnt`` operators in order; the artifact equals the live call
  bit for bit (the same plain versions run on the CPU) and the JAX package
  within the oracles' agreement of tests/test_torch_reference.py (costs
  1e-5 relative, gradients 1e-4 + 1e-6).
* compile: ``torch.compile(fullgraph=True, backend="aot_eager")`` of the
  public losses on the kernel routes, forward and backward, equals eager
  bit for bit; the length values are not checked under compile, as under
  jax.jit, and a wrong shape still raises RnntError.

On the CPU the operators run their plain versions; tests/test_torch_cuda.py
holds the same graphs on the card.
"""

import contextlib
import functools
import io
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

import monotonic_rnnt_tpu_torch as mt
from monotonic_rnnt_tpu import monotonic_rnnt_loss as jax_loss
from monotonic_rnnt_tpu.ops import alignment as jal
from monotonic_rnnt_tpu.ops import bands as jbands
from monotonic_rnnt_tpu.ops.banded import \
    monotonic_rnnt_loss_banded as jax_banded
from monotonic_rnnt_tpu_torch import config_override, convert, serving
from monotonic_rnnt_tpu_torch.ops import alignment as tal
from monotonic_rnnt_tpu_torch.ops import banded as tbanded
from monotonic_rnnt_tpu_torch.ops import bands as tbands
from monotonic_rnnt_tpu_torch.ops import loss as tloss
from monotonic_rnnt_tpu_torch.ops.cuda import _build, fused
from monotonic_rnnt_tpu_torch.ops.cuda import banded as cbanded
from monotonic_rnnt_tpu_torch.ops.cuda import kernels as tk
from monotonic_rnnt_tpu_torch.ops.cuda import banded_kernels as tbk
from monotonic_rnnt_tpu_torch.ops.cuda import split_kernels as tsk

B, T, S, V, H = 2, 6, 3, 5, 4
CHUNK = 4
WEIGHTS = torch.tensor([1.5, -0.25])        # one negative cotangent
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _numpy_case(seed=0):
    """logits [B, T, S+1, V], labels, lengths (one sample short) and a
    random alignment of the labels."""
    rng = np.random.RandomState(seed)
    logits = (rng.randn(B, T, S + 1, V) * 2).astype(np.float32)
    labels = rng.randint(1, V, (B, S)).astype(np.int32)
    ilen = np.array([T, T - 1], np.int32)
    slen = np.array([S, S - 1], np.int32)
    align = np.zeros((B, T), np.int32)
    for b in range(B):
        pos = np.sort(rng.choice(ilen[b], size=slen[b], replace=False))
        align[b, pos] = labels[b, :slen[b]]
    return logits, labels, ilen, slen, align


def _padded(seed=0, dtype=torch.float32):
    logits, labels, ilen, slen, _ = _numpy_case(seed)
    return convert.loss_inputs_from_numpy(logits, labels, ilen, slen,
                                          device="cpu", dtype=dtype)


def _banded(seed=0, dtype=torch.float32):
    """(band tensor, labels, ilen, slen, band_min, band_max) at the
    required width of a +-1 band around the alignment (W < S+1), and the
    JAX bands."""
    logits, labels, ilen, slen, align = _numpy_case(seed)
    jb = jbands.bands_from_alignment(jnp.asarray(align), jnp.asarray(ilen),
                                     jnp.asarray(slen), 1, 0)
    w = int(jbands.required_band_width(jnp.asarray(ilen), jnp.asarray(slen),
                                       jb, T, S + 1))
    assert w < S + 1
    tb = convert.bands_from_numpy(*jb, device="cpu")
    x, lab, il, sl = convert.loss_inputs_from_numpy(logits, labels, ilen,
                                                    slen, device="cpu")
    layout = tbands.compute_band_layout(il, sl, tb, T, S + 1, w)
    band = tbands.pack_band(x, layout).to(dtype).contiguous()
    return (band, lab, il, sl, tb.min_s, tb.max_s), jb


def _fused_joint(seed=0, dtype=torch.float32):
    """(enc, pred, labels, ilen, slen, w) and the joint: tanh(enc + pred)
    @ w in `dtype`."""
    rng = np.random.RandomState(seed + 1)
    _, labels, ilen, slen, _ = _numpy_case(seed)
    as_t = lambda a: torch.from_numpy(np.asarray(a))
    args = (as_t(rng.randn(B, T, H).astype(np.float32)),
            as_t(rng.randn(B, S + 1, H).astype(np.float32)),
            as_t(labels), as_t(ilen), as_t(slen),
            as_t(rng.randn(H, V).astype(np.float32)))

    def joint(params, enc_c, pred):
        return (torch.tanh(enc_c[:, :, None] + pred[:, None])
                @ params["w"]).to(dtype)

    return args, joint


def _band_joint(dtype):
    """The joint of _fused_joint on the band: pred_band [B, Tc, W, H]."""
    def joint(params, enc_c, pred_band):
        return (torch.tanh(enc_c[:, :, None] + pred_band)
                @ params["w"]).to(dtype)
    return joint


def _fused_joint_loss(joint):
    def loss(enc, pred, labels, ilen, slen, w):
        return mt.rnnt_loss_fused_joint(enc, pred, labels, ilen, slen, joint,
                                        {"w": w}, chunk_t=CHUNK)
    return loss


def _split_route(logits, labels, ilen, slen):
    with config_override(pipeline="split"):
        return fused.rnnt_loss_cuda(logits, labels, ilen, slen)


def _banded_route(band, labels, ilen, slen, band_min, band_max):
    return cbanded.rnnt_loss_banded_cuda(band, labels, ilen, slen,
                                         tbands.Bands(band_min, band_max))


def _alignment_route(logits, labels, ilen, slen):
    """Viterbi and the occupancies on the kernel route (tal._use_kernels
    patched by the caller on the CPU)."""
    vit = mt.viterbi_alignment(logits, labels, ilen, slen)
    return (vit.alignment, vit.score,
            mt.occupancy_posteriors(logits, labels, ilen, slen))


# --- the operators' calls on the routes ------------------------------------------

class _Recorder:
    """Stands in for torch.ops.mrnnt: keeps each operator call's arguments
    by (name, variant), then makes the call. The tensors are kept detached:
    the routes call the operators inside an autograd.Function's forward or
    backward, where nothing records a graph."""

    def __init__(self, real):
        self.real, self.calls = real, {}

    def __getattr__(self, name):
        op = getattr(self.real, name)

        def record(*args):
            self.calls.setdefault((name, _variant(name, args)), tuple(
                a.detach() if torch.is_tensor(a) else a for a in args))
            return op(*args)
        return record


def _variant(name, args):
    if name == "beta_grad_fused":
        return "unscaled" if args[-1] is None else "scaled"
    if name in ("softmax_stats", "grad_pass"):
        return f"labels{args[5 if name == 'grad_pass' else 1].dim()}d"
    if name == "softmax_stats_banded":
        return "beta" if args[-1] else "no-beta"
    return ""


@functools.lru_cache(maxsize=None)
def _route_calls(dtype_name):
    """Every operator call of the kernel routes on the CPU, in `dtype`."""
    dtype = DTYPES[dtype_name]
    rec = _Recorder(torch.ops.mrnnt)
    real_ops = torch.ops.mrnnt
    torch.ops.mrnnt = rec
    try:
        x, lab, il, sl = _padded(dtype=dtype)
        bands = tbands.default_bands(il, sl, T)
        xg = x.clone().requires_grad_(True)
        costs = tloss._LossCore.apply(xg, lab, il, sl, bands.min_s,
                                      bands.max_s, 0, "cuda")
        (costs * WEIGHTS).sum().backward()
        fused.rnnt_loss_cuda(x, lab, il, sl)
        with config_override(pipeline="split"):
            fused.rnnt_loss_cuda(x, lab, il, sl)
            fused.rnnt_loss_cuda(x, lab, il, sl, with_grads=False)
        band_args, _ = _banded(dtype=dtype)
        _banded_route(*band_args)
        cbanded.rnnt_loss_banded_cuda(*band_args[:4],
                                      tbands.Bands(*band_args[4:]),
                                      with_grads=False)
        args, joint = _fused_joint(dtype=dtype)
        enc = args[0].clone().requires_grad_(True)
        _fused_joint_loss(joint)(enc, *args[1:]).sum().backward()
        tb = tbands.Bands(*band_args[4:])
        w = band_args[0].shape[2]
        enc = args[0].clone().requires_grad_(True)
        mt.rnnt_loss_fused_joint_banded(
            enc, args[1], *args[2:5], _band_joint(dtype), {"w": args[5]},
            bands=tb,
            band_width=w, chunk_t=CHUNK).sum().backward()
        tsk.softmax_stats_partial(x)
    finally:
        torch.ops.mrnnt = real_ops
    return rec.calls


ROW_DTYPES = {"stats_alpha_fused": ("f32", "bf16"),
              "beta_grad_fused": ("f32", "bf16"),
              "softmax_stats": ("f32", "bf16"),
              "grad_pass": ("f32", "bf16"),
              "softmax_stats_banded": ("f32", "bf16"),
              "softmax_stats_partial": ("f32", "bf16"),
              "fwdbwd_scan": ("f32",), "alpha_scan": ("f32",),
              "beta_scan": ("f32",), "fwdbwd_scan_banded": ("f32",),
              "alpha_scan_banded": ("f32",)}
VARIANTS = {"beta_grad_fused": ("scaled", "unscaled"),
            "softmax_stats": ("labels2d", "labels3d"),
            "grad_pass": ("labels2d", "labels3d"),
            "softmax_stats_banded": ("beta", "no-beta")}
OPCHECK = [pytest.param(name, variant, dt, id=f"{name}-{variant}-{dt}"
                        if variant else f"{name}-{dt}")
           for name, dts in ROW_DTYPES.items()
           for variant in VARIANTS.get(name, ("",)) for dt in dts]


def test_every_row_is_an_operator_on_the_routes():
    """The eleven rows are registered, each with its CUDA implementation
    named <row>_cuda; the routes above call each of them, rows 1-2 under
    their PR-15 schemas."""
    assert sorted(tk.OPS) == sorted(ROW_DTYPES)
    for name, (_, module, attr) in tk.OPS.items():
        assert callable(getattr(module, attr)) and attr.endswith("_cuda")
    seen = {name for name, _ in _route_calls("f32")}
    assert seen == set(ROW_DTYPES)
    assert str(torch.ops.mrnnt.stats_alpha_fused.default._schema) == (
        "mrnnt::stats_alpha_fused(Tensor logits, Tensor labels_ext, "
        "Tensor a_lo, Tensor a_hi, SymInt blank_id) -> Tensor")
    assert str(torch.ops.mrnnt.beta_grad_fused.default._schema) == (
        "mrnnt::beta_grad_fused(Tensor logits, Tensor denom, "
        "Tensor lpb_bmask, Tensor lpl_bmask, Tensor aprev_masked, "
        "Tensor input_lengths, Tensor ll_bounded, Tensor beta_virtual, "
        "Tensor labels_ext, SymInt blank_id, Tensor? grad_scale) -> "
        "(Tensor, Tensor)")


@pytest.mark.parametrize("name, variant, dtype", OPCHECK)
def test_operator_passes_opcheck(name, variant, dtype):
    args = _route_calls(dtype)[(name, variant)]
    assert args[0].dtype == DTYPES[dtype]        # the logits, or a stream
    torch.library.opcheck(getattr(torch.ops.mrnnt, name).default, args)


# --- tracing with fake CUDA tensors ----------------------------------------------

# A CPU-only build has no device guard for CUDA, which a few Python tensor
# methods set before they dispatch (indexing, contiguous, ~). Under these
# shims a fake CUDA tensor takes such a method as a fake meta tensor (the
# same sizes, strides and storage) and its results are CUDA again; every
# other op reaches FakeTensorMode as it is, the mrnnt operators included.
_GUARDED = ("__getitem__", "__setitem__", "contiguous", "__invert__")
_META = torch.device("meta")


def _flip_to_meta(obj, flipped):
    if isinstance(obj, FakeTensor) and obj.fake_device.type == "cuda":
        flipped.append((obj, obj.fake_device))
        obj.fake_device = _META
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            _flip_to_meta(x, flipped)
    return flipped


def _on_meta(method):
    def call(*args):
        flipped = _flip_to_meta(args, [])
        try:
            out = method(*args)
        finally:
            for t, dev in flipped:
                t.fake_device = dev
        if isinstance(out, FakeTensor) and out.fake_device == _META:
            out.fake_device = flipped[0][1]
        return out
    return call


@contextlib.contextmanager
def fake_cuda():
    """FakeTensorMode in which torch.empty(..., device="cuda") makes fake
    CUDA tensors; warnings are errors (a fake tensor's data pointer warns);
    no launch is counted and no library loaded."""
    saved = {n: getattr(torch.Tensor, n) for n in _GUARDED}
    launches, libs = dict(tk.LAUNCHES), dict(_build._LIBS)
    try:
        for n, m in saved.items():
            setattr(torch.Tensor, n, _on_meta(m))
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            with FakeTensorMode():
                yield
    finally:
        for n, m in saved.items():
            setattr(torch.Tensor, n, m)
    assert tk.LAUNCHES == launches and _build._LIBS == libs


def _on_card(*tensors):
    """Empty CUDA tensors of the given tensors' shapes and dtypes (under
    fake_cuda: fake ones)."""
    return tuple(None if t is None else
                 torch.empty(t.shape, dtype=t.dtype, device="cuda")
                 for t in tensors)


def _assert_like(got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, FakeTensor) and g.device.type == "cuda"
        assert g.shape == w.shape and g.dtype == w.dtype


def _deferred_route(logits, labels, ilen, slen):
    costs, res = fused.rnnt_loss_cuda_deferred_fwd(logits, labels, ilen,
                                                   slen)
    return costs, fused.rnnt_loss_cuda_deferred_bwd(
        logits, labels, ilen, slen, res, torch.ones_like(costs))


def _banded_cost_only(x, labels, ilen, slen, band_min, band_max):
    return cbanded.rnnt_loss_banded_cuda(x, labels, ilen, slen,
                                         tbands.Bands(band_min, band_max),
                                         with_grads=False)[0]


def _fused_joint_route(dtype):
    args, joint = _fused_joint(dtype=dtype)
    return _fused_joint_loss(joint), args


# route -> dtype -> (the route's function, its CPU inputs)
FAKE_ROUTES = {
    "padded-deferred": lambda dt: (_deferred_route, _padded(dtype=dt)),
    "split": lambda dt: (_split_route, _padded(dtype=dt)),
    "banded": lambda dt: (_banded_route, _banded(dtype=dt)[0]),
    "banded-cost-only": lambda dt: (_banded_cost_only, _banded(dtype=dt)[0]),
    "fused-joint-forward": _fused_joint_route,
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("route", sorted(FAKE_ROUTES))
def test_route_traces_on_fake_cuda_tensors(route, dtype):
    """The route's outputs under FakeTensorMode on the card: the shapes
    and dtypes of the same route on CPU tensors, and no data read."""
    fn, args = FAKE_ROUTES[route](DTYPES[dtype])
    with torch.no_grad():
        want = fn(*args)
        with fake_cuda():
            _assert_like(fn(*_on_card(*args)), want)


@pytest.mark.parametrize("banded_search", [False, True])
def test_alignment_traces_on_fake_cuda_tensors(banded_search):
    """Viterbi and the occupancies (full lattice and band) on the kernel
    route, which fake CUDA tensors take by themselves."""
    if banded_search:
        args, _ = _banded()
        bands = tbands.Bands(*args[4:])

        def fn(x, lab, il, sl):
            vit = mt.viterbi_alignment_banded(x, lab, il, sl, bands=bands)
            return (vit.alignment, vit.score, mt.occupancy_posteriors_banded(
                x, lab, il, sl, bands=bands))
        args = args[:4]
    else:
        args, fn = _padded(), _alignment_route
    want = fn(*args)
    with fake_cuda():
        if banded_search:
            bands = tbands.Bands(*_on_card(*bands))
        _assert_like(fn(*_on_card(*args)), want)


def _wrapper_call(row, args):
    """The row's public wrapper on its operator's arguments."""
    if row == "softmax_stats_banded":
        return tbk.softmax_stats_banded(args[0], args[1], args[2:6], args[6],
                                        with_beta=args[7])
    return getattr(tk.OPS[row][1], row)(*args)


@pytest.mark.parametrize("row", sorted(ROW_DTYPES))
def test_wrapper_traces_on_fake_cuda_tensors(row):
    """Each wrapper on fake CUDA tensors gives its operator's fake outputs
    in the shapes and dtypes of its plain version."""
    args = _route_calls("f32")[(row, VARIANTS.get(row, ("",))[0])]
    want = _wrapper_call(row, args)
    with fake_cuda():
        fake_args = [torch.empty(a.shape, dtype=a.dtype, device="cuda")
                     if torch.is_tensor(a) else a for a in args]
        _assert_like(_wrapper_call(row, fake_args), want)


# --- exported graphs -------------------------------------------------------------

def _targets(blob):
    program = torch.export.load(io.BytesIO(blob))
    return [str(n.target).removeprefix("mrnnt.").removesuffix(".default")
            for n in program.graph.nodes
            if n.op == "call_function" and "mrnnt" in str(n.target)]


def _assert_equal(got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _exported(fn, args, targets):
    """fn's artifact: its graph holds `targets` in order, and it equals the
    live call bit for bit with no launch counted. Returns its outputs."""
    blob = serving.export_fn(fn, args)
    assert _targets(blob) == targets
    before = dict(tk.LAUNCHES)
    got = serving.import_fn(blob)(*args)
    _assert_equal(got, fn(*args))
    assert tk.LAUNCHES == before
    return got


def _jax_costs_grads(logits, labels, ilen, slen, *, bands=None):
    """The JAX oracle's costs and d(sum costs)/d logits (padded, or banded
    on the band tensor with `bands`)."""
    j = [jnp.asarray(a) for a in (logits, labels, ilen, slen)]

    def loss(x):
        if bands is None:
            return jax_loss(x, *j[1:], backend="reference")
        return jax_banded(x, *j[1:], bands=bands, backend="reference")

    costs, vjp = jax.vjp(loss, j[0])
    grads, = vjp(jnp.ones_like(costs))
    return np.asarray(costs), np.asarray(grads)


def _assert_jax(costs, grads, want):
    np.testing.assert_allclose(costs.numpy(), want[0], rtol=1e-5)
    if grads is not None:
        np.testing.assert_allclose(grads.numpy(), want[1], rtol=1e-4,
                                   atol=1e-6)


def test_split_route_exports_rows_3_4_6():
    args = _padded(seed=1)
    costs, grads = _exported(_split_route, args,
                             ["softmax_stats", "fwdbwd_scan", "grad_pass"])
    _assert_jax(costs, grads, _jax_costs_grads(*(a.numpy() for a in args)))


def test_split_cost_only_route_exports_rows_3_5():
    args = _padded(seed=1)

    def cost_only(*a):
        with config_override(pipeline="split"):
            return fused.rnnt_loss_cuda(*a, with_grads=False)[0]
    costs = _exported(cost_only, args, ["softmax_stats", "alpha_scan"])
    _assert_jax(costs, None, _jax_costs_grads(*(a.numpy() for a in args)))


def test_banded_route_exports_rows_7_8_6():
    args, jb = _banded(seed=3)
    costs, grads = _exported(
        _banded_route, args,
        ["softmax_stats_banded", "fwdbwd_scan_banded", "grad_pass"])
    _assert_jax(costs, grads, _jax_costs_grads(
        *(a.numpy() for a in args[:4]), bands=jb))
    cost_only = _exported(
        lambda *a: cbanded.rnnt_loss_banded_cuda(
            *a[:4], tbands.Bands(*a[4:]), with_grads=False)[0], args,
        ["softmax_stats_banded", "alpha_scan_banded"])
    assert torch.equal(cost_only, costs)


def test_fused_joint_forward_exports_rows_3_5():
    """The cost-only fused-joint loss: one softmax_stats a T-chunk, then
    the one alpha scan; its costs are the padded loss's (JAX) on the
    joint's logits."""
    args, joint = _fused_joint(seed=3)
    loss = _fused_joint_loss(joint)
    with torch.no_grad():
        costs = _exported(loss, args, ["softmax_stats"] * (T // CHUNK + 1)
                          + ["alpha_scan"])
        logits = joint({"w": args[5]}, args[0], args[1])
    want = _jax_costs_grads(logits.numpy(), *(a.numpy() for a in args[2:5]))
    _assert_jax(costs, None, want)


def test_alignment_exports_rows_3_4(monkeypatch):
    monkeypatch.setattr(tal, "_use_kernels", lambda x: True)
    args = _padded(seed=4)
    align, score, occ = _exported(
        _alignment_route, args, ["softmax_stats", "softmax_stats",
                                 "fwdbwd_scan"])
    j = [jnp.asarray(a.numpy()) for a in args]
    want = jal.viterbi_alignment(*j)
    np.testing.assert_array_equal(align.numpy(), np.asarray(want.alignment))
    np.testing.assert_allclose(score.numpy(), np.asarray(want.score),
                               rtol=1e-5)
    np.testing.assert_allclose(occ.numpy(),
                               np.asarray(jal.occupancy_posteriors(*j)),
                               atol=1e-5)


# --- torch.compile -----------------------------------------------------------------

def _compiled_equals_eager(fn, x, *rest):
    """torch.compile(fn) on (x, *rest): costs, and the gradient of the
    weighted costs with respect to x, equal to eager bit for bit."""
    compiled = torch.compile(fn, fullgraph=True, backend="aot_eager")
    outs = []
    for f in (compiled, fn):
        xg = x.clone().requires_grad_(True)
        costs = f(xg, *rest)
        grads, = torch.autograd.grad((costs * WEIGHTS).sum(), xg)
        outs.append((costs.detach(), grads))
    _assert_equal(outs[0], outs[1])
    torch._dynamo.reset()


@pytest.fixture
def kernel_routes(monkeypatch):
    """The public losses on their 'cuda' routes with CPU tensors, where
    the operators run their plain versions."""
    monkeypatch.setattr(tloss, "_resolve_backend", lambda b, x: "cuda")
    monkeypatch.setattr(tbanded, "_resolve_backend", lambda b, x: "cuda")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("pipeline", ["auto", "split"])
def test_public_loss_compiles_fullgraph(kernel_routes, pipeline, dtype):
    x, *rest = _padded(seed=5, dtype=DTYPES[dtype])
    with config_override(pipeline=pipeline):
        _compiled_equals_eager(mt.monotonic_rnnt_loss, x, *rest)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_public_banded_loss_compiles_fullgraph(kernel_routes, dtype):
    (x, lab, il, sl, lo, hi), _ = _banded(seed=6, dtype=DTYPES[dtype])
    bands = tbands.Bands(lo, hi)
    _compiled_equals_eager(
        lambda x, *a: mt.monotonic_rnnt_loss_banded(x, *a, bands=bands),
        x, lab, il, sl)


def test_compiled_loss_checks_shapes_not_length_values(kernel_routes):
    """Under torch.compile, as under jax.jit, a length past T_max is data
    and is not checked (eager raises); a wrong shape still raises
    RnntError, which a fullgraph compile names."""
    x, lab, il, sl = _padded(seed=7)
    long = il.clone()
    long[0] = T + 1
    with pytest.raises(mt.RnntError, match="exceed padded T_max"):
        mt.monotonic_rnnt_loss(x, lab, long, sl)
    compiled = torch.compile(mt.monotonic_rnnt_loss, fullgraph=True,
                             backend="aot_eager")
    assert compiled(x, lab, long, sl).shape == (B,)
    torch._dynamo.reset()
    with pytest.raises(mt.RnntError, match="labels second dim"):
        torch.compile(mt.monotonic_rnnt_loss, backend="aot_eager")(
            x, lab[:, :1], il, sl)
    torch._dynamo.reset()
    with pytest.raises(Exception, match="RnntError") as err:
        compiled = torch.compile(mt.monotonic_rnnt_loss, fullgraph=True,
                                 backend="aot_eager")
        compiled(x, lab[:, :1], il, sl)
    assert "labels second dim" in str(err.value.__cause__)
    torch._dynamo.reset()
