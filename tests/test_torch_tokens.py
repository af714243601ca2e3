"""The port's LM token stream (``repro_torch.data.tokens``) against the JAX
package's: the same ``(vocab_size, seed, worker, num_workers, position)``
gives byte-identical tokens and labels, and the arch workloads' corpora
(``ArchWorkload.make_data`` + the train/val split) are byte-identical."""
import numpy as np
import pytest

from repro.core import workloads as jworkloads
from repro.data import tokens as jtokens
from repro_torch.core import workloads as tworkloads
from repro_torch.data import tokens as ttokens


@pytest.mark.parametrize("vocab,seed,worker,workers,position", [
    (256, 0, 0, 1, 0),
    (49_152, 0, 0, 1, 0),
    (256, 7, 2, 4, 0),
    (1000, 3, 1, 3, 120),
    (32_000, 1, 0, 2, 17),
])
@pytest.mark.parametrize("batch,seq_len", [(1, 1), (4, 64), (3, 17)])
def test_token_stream_bytes_equal_jax(vocab, seed, worker, workers, position,
                                      batch, seq_len):
    kw = dict(vocab_size=vocab, seed=seed, worker=worker,
              num_workers=workers, position=position)
    j, t = jtokens.TokenStream(**kw), ttokens.TokenStream(**kw)
    for _ in range(2):                      # the position advances alike
        jb, tb = j.batch(batch, seq_len), t.batch(batch, seq_len)
        for key in ("tokens", "labels"):
            assert tb[key].dtype == jb[key].dtype == np.int32
            assert tb[key].tobytes() == jb[key].tobytes()
        assert t.state() == j.state()


def test_restore_reshards_like_jax():
    j, t = jtokens.TokenStream(256, 5), ttokens.TokenStream(256, 5)
    j.batch(4, 8), t.batch(4, 8)
    j.restore(j.state(), 1, 3)
    t.restore(t.state(), 1, 3)
    assert t.batch(2, 8)["tokens"].tobytes() == j.batch(2, 8)["tokens"].tobytes()


def test_lm_batches_equal_jax():
    for jb, tb in zip(jtokens.lm_batches(512, 2, 9, 3, seed=4),
                      ttokens.lm_batches(512, 2, 9, 3, seed=4), strict=True):
        assert tb["tokens"].tobytes() == jb["tokens"].tobytes()
        assert tb["labels"].tobytes() == jb["labels"].tobytes()


@pytest.mark.parametrize("name,rows,seed", [
    ("smollm_360m", 256, 0), ("smollm_360m", 64, 3), ("mamba2_370m", 40, 1)])
def test_arch_corpus_and_split_equal_jax(name, rows, seed):
    _, jtr, jva = jworkloads.make_workload(name, dataset="tokens", rows=rows,
                                           data_seed=seed)
    _, ttr, tva = tworkloads.make_workload(name, dataset="tokens", rows=rows,
                                           data_seed=seed)
    for j, t in ((jtr, ttr), (jva, tva)):
        assert t.x.tobytes() == j.x.tobytes()
        assert t.y.tobytes() == j.y.tobytes()
        assert t.n_classes == j.n_classes and t.name == j.name
