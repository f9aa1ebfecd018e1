"""Models shared by the port's decode tests: the JAX package's
``TransformerLM`` at test size, written to a model zip and read back by the
port, so that both packages decode with the same weights. Sizes as in
``tests/test_paged_kv.py``: vocab 23, hidden 32, 2 blocks, 4 heads,
``MAX_LEN`` 24; the draft has hidden 16 and 1 block."""

from deeplearning4j_tpu.model.serializer import write_model as jax_write
from deeplearning4j_tpu.model.zoo import TransformerLM as JaxLM
from deeplearning4j_tpu_torch.model import restore_multi_layer_network

MAX_LEN = 24
VOCAB = 23
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [2, 2]]


def lm_pair(tmp_path_factory, *, hidden: int = 32, n_layers: int = 2, n_heads: int = 4,
            seed: int = 5):
    """(JAX model, port model) with the same weights, through one zip."""
    jm = JaxLM(vocab_size=VOCAB, hidden=hidden, n_layers=n_layers, n_heads=n_heads,
               max_len=MAX_LEN, seed=seed).init()
    path = str(tmp_path_factory.mktemp("lm") / "lm.zip")
    jax_write(jm, path)
    return jm, restore_multi_layer_network(path, device="cpu")


def draft_pair(tmp_path_factory):
    """The draft: hidden 16, 1 block, its own seed (uncorrelated with the
    target, so rejections and rewinds happen)."""
    return lm_pair(tmp_path_factory, hidden=16, n_layers=1, n_heads=2, seed=99)


def collect(eng, prompts, max_tokens: int = 6, timeout: float = 120, **kw):
    """Submit every prompt at once and wait for all streams."""
    handles = [eng.submit(p, max_tokens=max_tokens, **kw) for p in prompts]
    return [h.result(timeout=timeout) for h in handles]
