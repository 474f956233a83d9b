"""The map's spill sort: ``phases.run_map_task``'s dispatch, its plain
version (``phases.spill_sort_plain``) and the ``spill_sort`` kernel
(``csrc/spill_sort.cu``).

On the CPU: CPU tensors take the plain version, which is the body
``run_map_task`` had before the kernel; ``run_map_task`` equals the
reference's for both apps; the map step writes its task rows straight into
the accumulators and no other rows; the kernel's wrapper refuses what the
kernel does not take, CPU tensors included.

Marked ``cuda`` (each skips without a card): the kernel bit for bit against
the plain version at every slot, dead slots included, on WordCount- and
Exim-like rows at the benchmark's shapes, the sharded map's (1, 2^24) rows
and edge rows; its pass counter against the digits that vary among the
live keys; a traced job's ``sort_passes``, and no library sort or gather
inside the spill sort's span.  This file imports JAX only inside the
reference test, so the card tests run where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_spill_sort.py
"""

import numpy as np
import pytest
import torch

import repro_torch.mapreduce as port
from repro_torch.kernels.spill_sort import ops as spill_ops
from repro_torch.kernels.spill_sort import spill_sort
from repro_torch.mapreduce import phases
from repro_torch.mapreduce.phases import PAD_KEY, spill_sort_plain
from repro_torch.telemetry import PhaseRecorder


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _old_body(keys, values, pvalid, setup):
    """``run_map_task``'s spill sort before the kernel, verbatim."""
    _, order = torch.sort(torch.where(pvalid, keys, PAD_KEY), dim=1, stable=True)
    keys = keys.gather(1, order)
    values = values.gather(1, order)
    pvalid = pvalid.gather(1, order)
    values = values + setup.to(values.dtype)[:, None]
    return keys, values, pvalid


def _random_rows(gen, N, C, device="cpu", *, lo=-(2**31), hi=2**31 - 1, valid=0.7,
                 pad_keys=0.05):
    """Keys in [lo, hi), some PAD_KEY; ``valid`` of the slots valid; values
    anything, dead slots included."""
    keys = torch.randint(lo, hi, (N, C), generator=gen, dtype=torch.int64, device=device)
    keys = keys.to(torch.int32)
    keys[torch.rand((N, C), generator=gen, device=device) < pad_keys] = PAD_KEY
    values = torch.randint(-(2**31), 2**31 - 1, (N, C), generator=gen, device=device,
                           dtype=torch.int64).to(torch.int32)
    pvalid = torch.rand((N, C), generator=gen, device=device) < valid
    return keys, values, pvalid


# ---- the CPU --------------------------------------------------------------


@pytest.mark.parametrize("out", [False, True])
def test_plain_version_is_the_old_body(out):
    gen = torch.Generator().manual_seed(1)
    keys, values, pvalid = _random_rows(gen, 5, 1000, lo=-50, hi=50)
    setup = torch.full((5,), 3e-17)
    want = _old_body(keys, values, pvalid, setup)
    addend = setup.to(torch.int32)
    if out:
        bufs = tuple(torch.empty((7, 1000), dtype=t.dtype) for t in want)
        rows = tuple(b[2:7] for b in bufs)
        got = spill_sort_plain(keys, values, pvalid, addend, out=rows)
        assert all(g.data_ptr() == r.data_ptr() for g, r in zip(got, rows))
    else:
        got = spill_sort_plain(keys, values, pvalid, addend)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_dispatch_sends_cpu_tensors_to_the_plain_version(monkeypatch):
    seen = []

    def kernel(*args):
        raise AssertionError("the kernel was called with CPU tensors")

    def plain(*args):
        seen.append(args[0].device.type)
        return spill_sort_plain(*args)

    monkeypatch.setattr(phases, "spill_sort", kernel)
    monkeypatch.setattr(phases, "spill_sort_plain", plain)
    cfg = port.JobConfig(4, 2, 2)
    tokens = torch.arange(40, dtype=torch.int32).reshape(4, 10) % 7
    phases.run_map_task(port.wordcount(16), cfg, tokens, torch.ones_like(tokens, dtype=torch.bool))
    job = port.build_job(port.wordcount(16), cfg, 40, device="cpu")
    job(tokens.reshape(-1))
    assert seen == ["cpu"] * 3  # the call above, then the job's two map waves


def test_meta_tensors_take_the_plain_version():
    cfg = port.JobConfig(4, 2, 2)
    tokens = torch.empty((3, 12), dtype=torch.int32, device="meta")
    keys, values, pvalid = phases.run_map_task(
        port.eximparse(64), cfg, tokens, torch.empty((3, 12), dtype=torch.bool, device="meta"))
    assert [t.shape for t in (keys, values, pvalid)] == [(3, 12)] * 3
    assert [t.dtype for t in (keys, values, pvalid)] == [torch.int32, torch.int32, torch.bool]


@pytest.mark.parametrize("app", ["wordcount", "exim"])
def test_run_map_task_on_cpu_equals_the_reference(app):
    import jax
    import jax.numpy as jnp

    import repro.mapreduce as ref
    from repro.mapreduce import phases as ref_phases

    if app == "wordcount":
        apps = (port.wordcount(300), ref.wordcount(300))
        corpus = port.wordcount_corpus(6000, 300, seed=3)
    else:
        apps = (port.eximparse(200), ref.eximparse(200))
        corpus = port.exim_mainlog(6001, 200, seed=3)
    M, S = 6, 1001  # splits that do not start on a record shift Exim's fields
    tokens = np.zeros(M * S, dtype=np.int32)
    tokens[:len(corpus)] = corpus
    valid = (np.arange(M * S) < len(corpus)).reshape(M, S)
    tokens = tokens.reshape(M, S)
    got = phases.run_map_task(apps[0], port.JobConfig(M, 3, 2), torch.from_numpy(tokens),
                              torch.from_numpy(valid))
    rcfg = ref.JobConfig(M, 3, 2)
    want = jax.vmap(lambda t, m: ref_phases.run_map_task(apps[1], rcfg, t, m))(
        jnp.asarray(tokens), jnp.asarray(valid))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("M,W,start", [(5, 8, 0), (7, 3, 6), (7, 3, 3)])
def test_map_step_writes_only_its_rows(M, W, start):
    """The step's clamped window of min(W, M) rows is written through the
    sort's ``out``; every other accumulator row keeps what it held."""
    app = port.wordcount(40)
    cfg = port.JobConfig(M, 2, W)
    corpus = port.wordcount_corpus(M * 50 - 7, 40, seed=M)
    plan = port.ExecutionPlan(app, cfg, len(corpus), device="cpu")
    splits, svalid = plan.prep()(torch.from_numpy(corpus))
    bufs = tuple(torch.full((M, plan.P), -5, dtype=torch.int32) for _ in range(2)) + (
        torch.ones((M, plan.P), dtype=torch.bool),)
    got = plan.map_stepper(W)(splits, svalid, *bufs, start)
    assert all(g is b for g, b in zip(got, bufs))
    n = min(W, M)
    s = max(0, min(start, M - n))
    want = phases.run_map_task(app, cfg, splits[s:s + n], svalid[s:s + n])
    for g, w in zip(got, want):
        assert torch.equal(g[s:s + n], w)
        rest = torch.cat([g[:s], g[s + n:]])
        assert (rest == (True if g.dtype == torch.bool else -5)).all()


def _operands(N=3, C=64, device="cpu"):
    gen = torch.Generator(device=device).manual_seed(0)
    return _random_rows(gen, N, C, device=device)


@pytest.mark.parametrize("fault,error", [
    ("keys int64", TypeError),
    ("pvalid int32", TypeError),
    ("shape mismatch", ValueError),
    ("out of the wrong shape", ValueError),
    ("out of the wrong dtype", ValueError),
    ("columns strided", ValueError),
    ("addend of the wrong length", ValueError),
    ("mixed devices", ValueError),
    ("CPU tensors", ValueError),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(fault, error):
    keys, values, pvalid = _operands()
    kw = {}
    if fault == "keys int64":
        keys = keys.to(torch.int64)
    elif fault == "pvalid int32":
        pvalid = pvalid.to(torch.int32)
    elif fault == "shape mismatch":
        values = values[:, :32]
    elif fault == "out of the wrong shape":
        kw["out"] = (keys[:2].clone(), values[:2].clone(), pvalid[:2].clone())
    elif fault == "out of the wrong dtype":
        kw["out"] = (keys.clone(), values.clone(), values.clone())
    elif fault == "columns strided":
        keys, values, pvalid = (t[:, ::2] for t in (keys, values, pvalid))
    elif fault == "addend of the wrong length":
        kw["addend"] = torch.zeros(2, dtype=torch.int32)
    elif fault == "mixed devices":
        keys = keys.to("meta")
    launches = spill_sort.launches
    with pytest.raises(error):
        spill_sort(keys, values, pvalid, **kw)
    assert spill_sort.launches == launches


def _varying_digits(keys, pvalid, bits=spill_ops.DIGIT_BITS):
    """The digits of ``bits`` bits that vary among each row's live keys
    (taken as key ^ 0x80000000), summed over the rows: the kernel's passes."""
    keys = keys.cpu().numpy().astype(np.int64)
    live = pvalid.cpu().numpy() & (keys != PAD_KEY)
    u = (keys & 0xFFFFFFFF) ^ 0x80000000
    total = 0
    for row, mask in zip(u, live):
        row = row[mask]
        for d in range(-(-32 // bits)):
            digit = (row >> (d * bits)) & ((1 << bits) - 1)
            total += int(len(row) > 0 and digit.min() != digit.max())
    return total


def test_varying_digits_counts_what_varies():
    keys = torch.tensor([[5, 5, 5, 7], [-1, 0, PAD_KEY, 3], [9, 9, 9, 9]], dtype=torch.int32)
    valid = torch.tensor([[1, 1, 1, 0], [1, 1, 1, 1], [0, 0, 0, 0]], dtype=torch.bool)
    # row 0: one key; row 1: -1 and 0 differ in every 8-bit digit; row 2: none live
    assert _varying_digits(keys, valid, bits=8) == 0 + 4 + 0
    assert _varying_digits(keys, valid, bits=11) == 3


# ---- the card -------------------------------------------------------------


def _assert_matches_plain(keys, values, pvalid, addend=None, n_out_rows=None):
    """The kernel against the plain version at every slot, into fresh
    outputs and, with ``n_out_rows``, into rows [1, N + 1) of garbage-filled
    buffers; its pass counter against the varying digits."""
    N, C = keys.shape
    plain_addend = torch.zeros(N, dtype=torch.int32, device=keys.device) \
        if addend is None else addend
    want = spill_sort_plain(keys, values, pvalid, plain_addend)
    passes = torch.zeros((), dtype=torch.int32, device=keys.device)
    launches = spill_sort.launches
    got = spill_sort(keys, values, pvalid, addend, passes=passes)
    torch.cuda.synchronize()
    assert spill_sort.launches == launches + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert int(passes) == _varying_digits(keys, pvalid)
    if n_out_rows:
        bufs = (torch.full((n_out_rows, C), -7, dtype=torch.int32, device=keys.device),
                torch.full((n_out_rows, C), -7, dtype=torch.int32, device=keys.device),
                torch.ones((n_out_rows, C), dtype=torch.bool, device=keys.device))
        rows = tuple(b[1:N + 1] for b in bufs)
        got = spill_sort(keys, values, pvalid, addend, out=rows)
        torch.cuda.synchronize()
        assert all(g.data_ptr() == r.data_ptr() for g, r in zip(got, rows))
        for b, w in zip(bufs, want):
            assert torch.equal(b[1:N + 1], w)
            fill = True if b.dtype == torch.bool else -7
            assert (b[0] == fill).all() and (b[N + 1:] == fill).all()


def _wordcount_rows(gen, N, C):
    """WordCount's map output: keys about Zipf a = 1 over 1.4e6 words, all
    valid, values 1."""
    keys = (1.4e6 ** torch.rand((N, C), generator=gen, device="cuda")).to(torch.int32)
    return keys, torch.ones_like(keys), torch.ones_like(keys, dtype=torch.bool)


def _exim_rows(gen, N, C):
    """Exim's map output: a third of each row records (ids under 2^25, a
    few the shifted small fields of a misparsed split, sizes as values),
    then a PAD tail, dead, with value 0."""
    n_rec = C // 3
    keys = torch.full((N, C), PAD_KEY, dtype=torch.int32, device="cuda")
    values = torch.zeros((N, C), dtype=torch.int32, device="cuda")
    pvalid = torch.zeros((N, C), dtype=torch.bool, device="cuda")
    keys[:, :n_rec] = torch.randint(0, 2**25, (N, n_rec), generator=gen, device="cuda",
                                    dtype=torch.int32)
    shifted = torch.rand((N, n_rec), generator=gen, device="cuda") < 0.01
    keys[:, :n_rec][shifted] = 3
    values[:, :n_rec] = torch.randint(200, 40000, (N, n_rec), generator=gen, device="cuda",
                                      dtype=torch.int32)
    pvalid[:, :n_rec] = True
    return keys, values, pvalid


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 1 << 24), (1, 1 << 24)])
def test_wordcount_rows_match_plain(shape):
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(shape[0])
    keys, values, pvalid = _wordcount_rows(gen, *shape)
    addend = torch.arange(shape[0], dtype=torch.int32, device="cuda") - 2
    _assert_matches_plain(keys, values, pvalid, addend, n_out_rows=shape[0] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 6_710_887), (5, 2_000_003)])
def test_exim_rows_with_their_pad_tail_match_plain(shape):
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(shape[1])
    keys, values, pvalid = _exim_rows(gen, *shape)
    _assert_matches_plain(keys, values, pvalid, torch.zeros(shape[0], dtype=torch.int32,
                                                            device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 2, 4095, 4096, 4097, 8192, 100_003])
@pytest.mark.parametrize("case", [
    "all dead", "one repeated key", "full 32-bit keys", "negative keys",
    "valid PAD keys among dead slots", "dead slots with values", "equal-key runs"])
def test_edge_rows_match_plain(case, C):
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(C)
    N = 3
    keys, values, pvalid = _random_rows(gen, N, C, "cuda")
    if case == "all dead":
        pvalid[:] = False
    elif case == "one repeated key":
        keys[:] = -12345
        pvalid[:] = True
    elif case == "negative keys":
        keys = torch.randint(-3000, 0, (N, C), generator=gen, device="cuda", dtype=torch.int32)
    elif case == "valid PAD keys among dead slots":
        keys[:, ::2] = PAD_KEY
        pvalid[:, ::3] = True
    elif case == "dead slots with values":
        keys = torch.randint(0, 100, (N, C), generator=gen, device="cuda", dtype=torch.int32)
    elif case == "equal-key runs":
        keys = torch.randint(0, 3, (N, C), generator=gen, device="cuda", dtype=torch.int32)
        values = torch.arange(N * C, dtype=torch.int32, device="cuda").reshape(N, C)
        pvalid[:] = True
    _assert_matches_plain(keys, values, pvalid, n_out_rows=N + 1)


@pytest.mark.cuda
def test_column_sliced_rows_match_plain():
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(7)
    wide = _random_rows(gen, 4, 30_001, "cuda", lo=-70_000, hi=70_000)
    keys, values, pvalid = (t[:, 3:20_003] for t in wide)
    assert keys.stride(0) == 30_001
    _assert_matches_plain(keys, values, pvalid, torch.tensor([1, -2, 3, 0], dtype=torch.int32,
                                                             device="cuda"), n_out_rows=6)


@pytest.mark.cuda
def test_traced_job_counts_its_passes_and_sorts_with_the_kernel():
    """A (16, 7, 8) WordCount job at 2^22 tokens, traced: ``sort_passes`` is
    the digits that vary among each task row's live keys, summed; inside
    the spill sort's span no library sort or gather runs, only the kernel."""
    _needs_card()
    n = 1 << 22
    corpus = port.wordcount_corpus(n, 1_400_000, zipf_a=1.0, seed=11)
    app, cfg = port.wordcount(1_400_000), port.JobConfig(16, 7, 8, reduce_backend="cuda")
    recorder = PhaseRecorder()
    job = port.ExecutionPlan(app, cfg, n, device="cuda").traced(recorder)
    tokens = torch.from_numpy(corpus).cuda()
    want = port.build_job(app, cfg, n, device="cpu")(torch.from_numpy(corpus))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = job(tokens)
        torch.cuda.synchronize()
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    rows = tokens.reshape(16, -1)
    assert recorder.last.counter("map", "sort_passes") == _varying_digits(
        rows, torch.ones_like(rows, dtype=torch.bool))
    events = prof.events()
    sorts = [e for e in events if e.name == "mapreduce.map.spill_sort"]
    assert len(sorts) == 2
    inside = [e.name for e in events for s in sorts
              if e is not s and s.time_range.start <= e.time_range.start
              and e.time_range.end <= s.time_range.end and e.thread == s.thread]
    assert "repro_torch::spill_sort" in inside
    assert not [name for name in inside if "sort" in name.split("::")[-1]
                and name != "repro_torch::spill_sort" or "gather" in name], inside
