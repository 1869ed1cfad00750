"""The traffic generator: deterministic from the seed, the same work for
every seed, and the stated distributions."""
import numpy as np
import pytest

import portbench_testlib as tl  # noqa: F401  (puts the repo on sys.path)
from portbench.traffic import offered, round_up

DOCQA = {"arrivals": "poisson",
         "prompt": {"dist": "lognormal", "median": 1536, "sigma": 0.5,
                    "min": 512, "max": 3584},
         "output": {"dist": "uniform", "min": 64, "max": 192}}
BIG_SEED = 2 ** 31 + 12345


def test_same_seed_same_requests():
    a = offered(DOCQA, 2.0, 51, BIG_SEED, 102400)
    b = offered(DOCQA, 2.0, 51, BIG_SEED, 102400)
    assert [(r.due, r.max_new_tokens) for r in a] == \
        [(r.due, r.max_new_tokens) for r in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))


def test_seeds_share_the_work_in_another_order():
    a = offered(DOCQA, 2.0, 51, 1, 102400)
    b = offered(DOCQA, 2.0, 51, 2, 102400)
    assert sorted(len(r.prompt) for r in a) == sorted(len(r.prompt) for r in b)
    assert sorted(r.max_new_tokens for r in a) == \
        sorted(r.max_new_tokens for r in b)
    gaps = [np.sort(np.diff([r.due for r in x] + [51.0])) for x in (a, b)]
    np.testing.assert_allclose(gaps[0], gaps[1], rtol=1e-9)
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b]


def test_a_seed_rotates_one_arrangement():
    """Each seed's window is a rotation of one sample path: the same
    requests with the same neighbours."""
    a = offered(DOCQA, 1.2, 51, 11, 102400)
    b = offered(DOCQA, 1.2, 51, 12, 102400)
    sizes = [[(len(r.prompt), r.max_new_tokens) for r in x] for x in (a, b)]
    n = len(sizes[0])
    turns = [k for k in range(n) if sizes[1] == sizes[0][k:] + sizes[0][:k]]
    assert len(turns) == 1 and turns[0] != 0
    gaps_a = np.diff([r.due for r in a] + [51.0])
    gaps_b = np.diff([r.due for r in b] + [51.0])
    k = turns[0]
    np.testing.assert_allclose(gaps_b, np.roll(gaps_a, -k), rtol=1e-9)


def test_docqa_distributions():
    reqs = offered(DOCQA, 4.0, 500, 7, 102400)
    lengths = np.array([len(r.prompt) for r in reqs])
    outs = np.array([r.max_new_tokens for r in reqs])
    assert len(reqs) == 2000
    assert lengths.min() >= 512 and lengths.max() <= 3584
    assert abs(np.median(lengths) - 1536) <= 2
    # sigma of the log-lengths inside the clip: the quantiles of a
    # lognormal of sigma 0.5
    inner = np.log(lengths[(lengths > 512) & (lengths < 3584)])
    assert 0.40 < inner.std() < 0.5
    assert outs.min() == 64 and outs.max() == 192
    assert abs(outs.mean() - 128) < 0.5
    due = np.array([r.due for r in reqs])
    assert due[0] == 0.0 and due[-1] < 500 and np.all(np.diff(due) > 0)
    gaps = np.diff(due)
    assert abs(gaps.mean() - 0.25) < 0.01
    assert 0.9 < gaps.std() / gaps.mean() < 1.1       # exponential: cv 1
    toks = np.concatenate([r.prompt for r in reqs])
    assert toks.min() >= 0 and toks.max() < 102400
    assert abs(toks.mean() / 102400 - 0.5) < 0.01


@pytest.mark.parametrize("n,multiple,want", [(300, 512, 300), (512, 512, 512),
                                             (513, 512, 1024),
                                             (3584, 512, 3584),
                                             (700, 0, 700)])
def test_round_up(n, multiple, want):
    assert round_up(n, multiple) == want


def test_prompt_multiple():
    reqs = offered(DOCQA, 2.0, 30, 5, 1000, prompt_multiple=512)
    assert all(len(r.prompt) % 512 == 0 for r in reqs)
    plain = offered(DOCQA, 2.0, 30, 5, 1000)
    assert [round_up(len(r.prompt), 512) for r in plain] == \
        [len(r.prompt) for r in reqs]
