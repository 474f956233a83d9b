"""The device-side generators' frequencies, on the CPU."""

import numpy as np
import torch

from portbench import gen

N = 1 << 20


def test_zipf_ranks_follow_the_law():
    g = gen.generator(2**32 + 11, "cpu")
    ids = gen.wordcount(N, 4096, 1.3, g, "cpu")
    assert ids.dtype == torch.int32 and int(ids.min()) >= 0 and int(ids.max()) < 4096
    freq = np.bincount(ids.numpy(), minlength=4096) / N
    p = gen.zipf_probs(4096, 1.3, "cpu").numpy()
    # the head within 4 standard errors, and the law's slope on ranks 1-64
    sd = np.sqrt(p[:16] * (1 - p[:16]) / N)
    assert np.all(np.abs(freq[:16] - p[:16]) < 4 * sd)
    slope = np.polyfit(np.log(np.arange(1, 65)), np.log(freq[:64]), 1)[0]
    assert abs(slope + 1.3) < 0.05


def test_the_configuration_law_has_english_heads():
    """Zipf a = 1 over 1.4e6 words: the top word is 1 / H(V) of the text,
    about 6.8 %, and the second half of it."""
    from portbench.spec import load_cell

    data = load_cell("wc-fixed").config["data"]
    ids = gen.wordcount(N, data["vocab"], data["zipf_a"], gen.generator(3, "cpu"), "cpu")
    freq = np.bincount(ids.numpy(), minlength=4)[:4] / N
    harmonic = np.sum(1.0 / np.arange(1, data["vocab"] + 1))
    assert abs(freq[0] - 1 / harmonic) < 0.002 and abs(freq[0] - 0.068) < 0.002
    assert abs(freq[0] / freq[1] - 2) < 0.05
    assert int(ids.max()) < data["vocab"]


DATA = {"burst": [2, 6], "events": 8, "size": [200, 3999]}


def test_exim_bursts_events_and_sizes():
    g = gen.generator(7, "cpu")
    ids, event, size, bursts = gen.exim_fields(N, DATA, g, "cpu")
    assert len(ids) == len(event) == len(size) == N
    b = np.bincount(bursts.numpy(), minlength=7)
    assert b[:2].sum() == 0 and np.all(np.abs(b[2:] / b.sum() - 0.2) < 0.01)
    e = np.bincount(event.numpy(), minlength=8)
    assert e.shape == (8,) and np.all(np.abs(e / N - 1 / 8) < 0.005)
    s = size.numpy()
    assert s.min() == 200 and s.max() == 3999
    assert abs(s.mean() - (200 + 3999) / 2) < 5
    # one id a message, rising: about N / 4 of them, each one burst long
    per_id = np.bincount(ids.numpy())
    assert per_id.min() >= 1 and per_id[:-1].min() >= 2 and per_id.max() <= 6
    assert abs(len(per_id) / (N / 4) - 1) < 0.01
    assert np.all(np.diff(ids.numpy()) >= 0)
    assert len(per_id) <= gen.exim_key_space(3 * N, DATA)


def test_exim_stream_is_records_of_bursts():
    n = 3 * 1000 + 2
    stream = gen.exim(n, DATA, gen.generator(5, "cpu"), "cpu")
    ids, _, _, bursts = gen.exim_fields(n // 3 + 1, DATA, gen.generator(5, "cpu"), "cpu")
    assert stream.shape == (n,) and stream.dtype == torch.int32
    assert torch.equal(stream[0::3], ids[: len(stream[0::3])])
    runs = torch.repeat_interleave(torch.arange(len(bursts)), bursts)[: len(ids)]
    assert torch.equal(ids, runs.to(torch.int32))


def test_one_seed_one_corpus():
    config = {"app": "wordcount", "tokens": 4096, "data": {"vocab": 4096, "zipf_a": 1.3}}
    a = gen.corpus(config, 2**31 + 3, "cpu")
    assert torch.equal(a, gen.corpus(config, 2**31 + 3, "cpu"))
    assert not torch.equal(a, gen.corpus(config, 2**31 + 4, "cpu"))
