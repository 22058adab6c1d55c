"""The port's token loader (``repro_torch.data``) against the reference's
(``repro.data``): every batch bit-identical."""

import itertools

import numpy as np
import pytest

from repro.data import DataConfig as JDataConfig
from repro.data import ShardedLoader as JShardedLoader
from repro_torch.data import DataConfig, ShardedLoader


def loaders(vocab, seq, batch, seed, n_hosts, host):
    kw = dict(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed, n_hosts=n_hosts)
    return ShardedLoader(DataConfig(**kw), host), JShardedLoader(JDataConfig(**kw), host)


def same(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b) == ["labels", "tokens"]
    for k in a:
        assert a[k].dtype == b[k].dtype == np.int32
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("seed,n_hosts,host", [(0, 1, 0), (0, 4, 0), (0, 4, 3), (7, 2, 1),
                                               (123, 8, 5)])
@pytest.mark.parametrize("step", [0, 1, 17])
def test_batches_bit_identical(seed, n_hosts, host, step):
    port, ref = loaders(512, 24, 16, seed, n_hosts, host)
    got = port.get(step)
    same(got, ref.get(step))
    assert got["tokens"].shape == (16 // n_hosts, 24)
    assert np.array_equal(got["tokens"][:, 1:], got["labels"][:, :-1])
    for straggler in range(n_hosts):
        same(port.reissue(step, straggler), ref.reissue(step, straggler))


def test_reissue_is_the_stragglers_own_batch():
    mine, _ = loaders(300, 8, 6, 3, 3, 0)
    theirs, _ = loaders(300, 8, 6, 3, 3, 2)
    same(mine.reissue(5, 2), theirs.get(5))


def test_iteration_and_refusal():
    port, ref = loaders(1000, 16, 4, 1, 2, 1)
    for got, want in zip(itertools.islice(port, 3), itertools.islice(ref, 3)):
        same(got, want)
    with pytest.raises(ValueError, match="divisible"):
        loaders(10, 4, 5, 0, 2, 0)
