"""The port's LM token pipeline (``repro_torch.data.lm``) and its
architecture registry (``repro_torch.configs``) against the JAX package's.

The port draws its uniforms from ``numpy.random.default_rng((seed,
step))`` (the reference's threefry stream has no torch counterpart), so
its batches are not the reference's; ``_zipf_tokens`` maps the reference's
own uniforms to the reference's tokens bit for bit.  Anchors:
``tests/test_hlo_and_data.py:81``, ``tests/test_models_smoke.py:146``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import lm as jlm
from repro_torch import configs
from repro_torch.data import lm


def test_lm_batches_deterministic_and_shardable():
    cfg = lm.LmDataConfig(vocab=500, seq_len=16, global_batch=8, seed=3)
    b1, b2 = lm.batch_at(cfg, 5), lm.batch_at(cfg, 5)
    assert b1["tokens"].dtype == torch.int32 and b1["tokens"].shape == (8, 16)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(lm.batch_at(cfg, 6)["tokens"], b1["tokens"])
    # host shards tile the global batch exactly
    parts = [lm.host_shard_at(cfg, 5, s, 4)["tokens"] for s in range(4)]
    assert torch.equal(torch.cat(parts), b1["tokens"])
    # labels are next-token shifted
    b = lm.batch_at(lm.LmDataConfig(vocab=500, seq_len=16, global_batch=2, seed=0), 0)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert int(b["tokens"].min()) >= 1 and int(b["tokens"].max()) <= 499  # ranks >= 1
    with pytest.raises(ValueError, match="multiple"):
        lm.host_shard_at(cfg, 5, 0, 3)


@pytest.mark.parametrize("vocab,a", [(32064, 1.1), (500, 1.1), (202048, 1.1), (1000, 1.5)])
def test_zipf_tokens_bit_equal_on_the_references_uniforms(vocab, a):
    """The reference's ``_zipf_tokens`` against the port's on the uniforms
    the reference draws (``jax.random.uniform(key, shape, f32, 1e-6,
    1.0)``): 1,048,576 tokens equal, the clip at vocab - 1 (the f32 power
    past int32 and past the f32 range) included."""
    key = jax.random.key(7)
    shape = (256, 4096)
    u = jax.random.uniform(key, shape, jnp.float32, 1e-6, 1.0)
    want = np.asarray(jlm._zipf_tokens(key, shape, vocab, a))
    got = lm._zipf_tokens(np.asarray(u), vocab, a)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got == vocab - 1).any() and (got == 1).any()


def test_registry_covers_the_ported_architectures():
    """``test_models_smoke.py:146`` held to the port's registry: the five LM
    architectures with their 4 cells each (20) and the two ANN configs.
    The reference's count, 10 architectures and 40 cells, comes with the
    GNN and recsys configs."""
    assert len(configs.ASSIGNED) == 5
    assert sum(len(configs.get(a).cells) for a in configs.ASSIGNED) == 20
    assert sorted(configs.all_ids()) == sorted(configs.ASSIGNED + ["ann-glove", "ann-word2vec"])
    assert configs.all_ids(include_ann=False) == configs.ASSIGNED
    for a in configs.ASSIGNED:
        spec = configs.get(a)
        assert spec.family == "lm" and spec.source
        assert [c.name for c in spec.cells] == ["train_4k", "prefill_32k", "decode_32k",
                                                 "long_500k"]
        assert spec.make_model(spec.cells[0]) is not None
    assert configs.get("ann-word2vec").family == "ann"
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get("graphsage-reddit")
