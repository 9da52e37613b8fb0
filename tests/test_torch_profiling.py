"""The port's profiling utilities against the JAX package's
(monotonic_rnnt_tpu/utils/profiling.py)."""

import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monotonic_rnnt_tpu.utils import profiling as jprof
from monotonic_rnnt_tpu_torch.utils import profiling as tprof


@pytest.mark.parametrize("shape", [(5,), (3, 4), (2, 3, 6)])
def test_default_perturb_matches_jax_exactly(shape):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    acc = np.float32(3.0e19)       # moves the first element by 0.3
    want = np.asarray(jprof.default_perturb(jnp.asarray(x), jnp.asarray(acc)))
    xt = torch.from_numpy(x)
    got = tprof.default_perturb(xt, torch.tensor(acc))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, x)
    np.testing.assert_array_equal(xt.numpy(), x)     # out of place


def test_dependent_loop_chains_every_iteration():
    calls, seen = [], []

    def step(x, scale):
        calls.append(1)
        seen.append(float(x[0]))
        return x * scale

    def perturb(x, acc):
        return x + acc

    x = torch.ones(4)
    mean, var = tprof.dependent_loop_bench(step, perturb, lambda o: o.sum(),
                                           (x, 1.0), iters=5, trials=2)
    # One warm-up chain and two timed ones, five steps each, each step fed
    # the previous step's feedback: x_{i+1} = x_i + sum(x_i).
    assert len(calls) == 15 and mean > 0 and var >= 0
    assert seen == [1.0, 5.0, 25.0, 125.0, 625.0] * 3


def test_corrected_benches_fit_two_points_and_refuse_one_iteration():
    made = []

    def make_run(n):
        made.append(n)

        def run(x):
            for _ in range(n):
                x = x + 1.0
            return x
        return run

    per_iter = tprof.corrected_args_loop_bench(make_run, (torch.zeros(3),),
                                               iters=8, trials=2)
    assert made == [8, 2] and np.isfinite(per_iter)
    with pytest.raises(ValueError, match="iters must be >= 2"):
        tprof.corrected_args_loop_bench(make_run, (torch.zeros(3),), iters=1)
    with pytest.raises(ValueError, match="iters must be >= 2"):
        jprof.corrected_args_loop_bench(make_run, (jnp.zeros(3),), iters=1)
    with pytest.raises(ValueError, match="iters must be >= 2"):
        tprof.corrected_loop_bench(lambda x: x, tprof.default_perturb,
                                   lambda o: o.sum(), (torch.zeros(3),),
                                   iters=1)
    per, overhead = tprof.corrected_loop_bench(
        lambda x: x * 2, tprof.default_perturb, lambda o: o.sum(),
        (torch.ones(3),), iters=8, trials=2)
    assert np.isfinite(per) and overhead >= 0


def test_phase_timer_prints_and_marks_the_trace(tmp_path):
    out = io.StringIO()
    with tprof.device_trace(str(tmp_path)) as prof:
        with tprof.phase_timer("unit-phase", file=out):
            torch.ones(64).sum()
    assert out.getvalue().startswith("[mrnnt] unit-phase: ")
    assert any(e.key == "unit-phase" for e in prof.key_averages())
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())
             ["traceEvents"]}
    assert "unit-phase" in names
    quiet = io.StringIO()
    with tprof.phase_timer("silent", enabled=False, file=quiet):
        pass
    assert quiet.getvalue() == ""
