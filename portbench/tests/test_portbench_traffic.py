"""The traffic generator: a seed fixes the requests; seeds differ only in
order and tokens, never in the mix of lengths."""

import numpy as np

from portbench import traffic


def requests(name, seed, n, vocab=1000):
    s = traffic.Stream(traffic.load(name), vocab, seed)
    return [s.next() for _ in range(n)]


def test_same_seed_same_requests():
    a = requests("chat", 2**31 + 11, 130)
    b = requests("chat", 2**31 + 11, 130)
    assert all(len(p) == len(q) and o == r and np.array_equal(p, q)
               for (p, o), (q, r) in zip(a, b))


def test_seeds_share_the_length_mix():
    for name in ("chat", "longprompt"):
        block = traffic.load(name)["block"]
        a = requests(name, 3, 2 * block)
        b = requests(name, 4_000_000_007, 2 * block)
        for lo in (0, block):
            pa = sorted(len(p) for p, _ in a[lo:lo + block])
            pb = sorted(len(p) for p, _ in b[lo:lo + block])
            assert pa == pb
            assert sorted(o for _, o in a[lo:lo + block]) == sorted(o for _, o in b[lo:lo + block])
        assert [len(p) for p, _ in a] != [len(p) for p, _ in b]


def test_lengths_are_the_stated_quantiles():
    mix = traffic.load("chat")
    p = traffic.quantile_lengths(mix["prompt_tokens"], mix["block"])
    assert min(p) >= 64 and max(p) <= 1024 and p == sorted(p)
    # log-uniform over [64, 1024]: mean (hi - lo) / ln(hi / lo) = 346.2
    assert abs(sum(p) / len(p) - 960 / np.log(16)) < 2


def test_zipf_ids_in_range_and_skewed():
    s = traffic.Stream(traffic.load("chat"), 5000, 9)
    ids = s.tokens(50_000)
    assert ids.min() >= 0 and ids.max() < 5000
    counts = np.bincount(ids, minlength=5000)
    top = counts.max() / len(ids)
    # Zipf exponent 1 over 5000 ranks: the first rank takes 1 / H(5000) = 11.0%
    assert 0.09 < top < 0.13
