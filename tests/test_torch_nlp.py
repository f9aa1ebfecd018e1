"""The port's NLP tier (``deeplearning4j_tpu_torch/nlp``) against the JAX
package's on the same inputs, on the CPU.

The tokenizers and ``BertIterator`` are copies of the JAX package's host
code: their ids, masks and MLM corruptions must be equal bit for bit. The
embedding trainers draw the same pairs, negatives, permutations and
initial tables from the same ``RandomState`` in the same order, and both
step in float32; their tables may differ only by summation order:
``TOL_TABLE`` (absolute, on tables of magnitude ~0.1 for Word2Vec and
ParagraphVectors and ~1 for GloVe; the gaps read 4e-9 and 1.5e-7).
``Word2Vec(mesh=)`` runs on two gloo ranks over row-sharded tables: a
lookup all-reduces rows that are non-zero on their owner only, and each
rank adds its own rows in the unsharded order, so its tables must equal
the port's unsharded run bit for bit. A ``WordVectorSerializer`` file
written by one package reads in the other."""

import numpy as np
import pytest

from deeplearning4j_tpu import nlp as jnlp

from deeplearning4j_tpu_torch import nlp as tnlp
from deeplearning4j_tpu_torch.tools.parallel_cases import result, run_world

TOL_TABLE = 1e-6

_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
          "the", "quick", "brown", "fox", "jump", "##ed", "##s",
          "over", "lazy", "dog", "un", "##want", ",", "!"]
_TEXTS = ["The quick brown fox jumped over the lazy dog!",
          "Unwanted, jumps over Café zebra", "", "the   dog\tjumps\nover",
          "foxes jump quickly"]


def _corpus(n_sent=60, n_words=30, length=10, seed=0):
    """Zipf-distributed sentences over ``n_words`` words."""
    rs = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, n_words + 1)
    p /= p.sum()
    return [[f"w{i}" for i in rs.choice(n_words, length, p=p)] for _ in range(n_sent)]


def _tokenizers():
    return (jnlp.BertWordPieceTokenizer(jnlp.Vocabulary(_VOCAB)),
            tnlp.BertWordPieceTokenizer(tnlp.Vocabulary(_VOCAB)))


@pytest.mark.parametrize("lower", [True, False])
def test_tokenizers_match_jax(lower):
    jb, tb = jnlp.BasicTokenizer(lower_case=lower), tnlp.BasicTokenizer(lower_case=lower)
    jw = jnlp.BertWordPieceTokenizer(jnlp.Vocabulary(_VOCAB), lower_case=lower)
    tw = tnlp.BertWordPieceTokenizer(tnlp.Vocabulary(_VOCAB), lower_case=lower)
    for text in _TEXTS:
        assert tb.tokenize(text) == jb.tokenize(text)
        assert tw.tokenize(text) == jw.tokenize(text)
        assert tw.encode(text) == jw.encode(text)


def _batches(it):
    out = []
    for mds in it:
        arrays = list(mds.features) + list(mds.labels) + list(mds.labels_masks or [])
        out.append(arrays)
    return out


@pytest.mark.parametrize("task", ["mlm", "classification"])
def test_bert_iterator_matches_jax(task):
    jt, tt = _tokenizers()
    sents = [_TEXTS[i % len(_TEXTS)] for i in range(11)]
    if task == "mlm":
        kw = dict(sentences=sents, max_length=12, batch_size=4, mask_prob=0.3, seed=7)
        j = jnlp.BertIterator(jt, task=jnlp.BertTask.UNSUPERVISED, **kw)
        t = tnlp.BertIterator(tt, task=tnlp.BertTask.UNSUPERVISED, **kw)
    else:
        kw = dict(sentences=sents, labels=[i % 3 for i in range(11)], num_classes=3,
                  max_length=8, batch_size=4)
        j = jnlp.BertIterator(jt, task=jnlp.BertTask.SEQ_CLASSIFICATION, **kw)
        t = tnlp.BertIterator(tt, task=tnlp.BertTask.SEQ_CLASSIFICATION, **kw)
    assert len(t) == len(j) == 3
    for _epoch in range(2):  # the MLM corruption resamples every epoch
        jb, tb = _batches(j), _batches(t)
        assert len(jb) == len(tb) == 3
        for ja, ta in zip(jb, tb):
            assert len(ja) == len(ta) == (4 if task == "mlm" else 3)
            for a, b in zip(ja, ta):
                assert a.dtype == b.dtype and np.array_equal(a, b)


def _pair(cls, **kw):
    return getattr(jnlp, cls)(**kw), getattr(tnlp, cls)(device="cpu", **kw)


@pytest.mark.parametrize("hs", [False, True], ids=["negative-sampling", "hierarchical-softmax"])
def test_word2vec_matches_jax(hs):
    sents = _corpus()
    j, t = _pair("Word2Vec", vector_size=8, window=3, min_count=2, negative=4, hs=hs,
                 epochs=2, batch_size=64, seed=5)
    j.fit(sents)
    t.fit(sents)
    assert t.vocab == j.vocab
    assert t.syn0.dtype == np.float32 and t.syn0.shape == j.syn0.shape
    np.testing.assert_allclose(t.syn0, j.syn0, rtol=0, atol=TOL_TABLE)
    np.testing.assert_allclose(t.syn1, j.syn1, rtol=0, atol=TOL_TABLE)
    if hs:
        for name in ("hs_points", "hs_codes", "hs_mask"):
            assert np.array_equal(getattr(t, name), getattr(j, name))
    assert t.words_nearest("w0", 3) == j.words_nearest("w0", 3)


def test_glove_matches_jax():
    sents = _corpus()
    j, t = _pair("Glove", vector_size=8, window=3, min_count=2, epochs=3, batch_size=64, seed=5)
    j.fit(sents)
    t.fit(sents)
    assert t.vocab == j.vocab
    np.testing.assert_allclose(t.syn0, j.syn0, rtol=0, atol=TOL_TABLE)
    assert abs(t.similarity("w0", "w1") - j.similarity("w0", "w1")) < 1e-5


def test_paragraph_vectors_match_jax():
    sents = _corpus(n_sent=40)
    j, t = _pair("ParagraphVectors", vector_size=8, window=3, min_count=2, epochs=3,
                 batch_size=64, seed=5)
    j.fit([jnlp.LabelledDocument(s, f"d{i}") for i, s in enumerate(sents)])
    t.fit([tnlp.LabelledDocument(s, f"d{i}") for i, s in enumerate(sents)])
    np.testing.assert_allclose(t.doc_vectors, j.doc_vectors, rtol=0, atol=TOL_TABLE)
    np.testing.assert_allclose(t._syn1_final, j._syn1_final, rtol=0, atol=TOL_TABLE)
    unseen = ["w1", "w2", "w3", "w5", "not-in-vocab"]
    np.testing.assert_allclose(t.infer_vector(unseen), j.infer_vector(unseen), rtol=0,
                               atol=TOL_TABLE)
    assert t.nearest_labels("d0", 3) == j.nearest_labels("d0", 3)
    with pytest.raises(ValueError, match="no in-vocabulary"):
        t.infer_vector(["zzz"])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_word_vector_files_cross_packages(tmp_path, writer):
    rs = np.random.RandomState(3)
    vocab = ["alpha", "beta", "gamma"]
    vectors = rs.randn(3, 4).astype(np.float32)
    w, r = (jnlp, tnlp) if writer == "jax" else (tnlp, jnlp)
    path = str(tmp_path / "vectors.txt")
    w.WordVectorSerializer.write_word_vectors(w.WordVectors(vocab, vectors), path)
    got = r.WordVectorSerializer.read_word_vectors(path)
    assert got.vocab == vocab
    np.testing.assert_allclose(got.syn0, vectors, rtol=1e-5)
    with pytest.raises(ValueError, match="whitespace"):
        w.WordVectorSerializer.write_word_vectors(w.WordVectors(["a b"], vectors[:1]), path)


_MESH_KW = dict(vector_size=8, window=3, min_count=2, negative=4, epochs=1, batch_size=64,
                seed=5)


@pytest.fixture(scope="module")
def w2v_world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("w2v_mesh"))
    sents = _corpus(n_words=31)  # V = 31: syn0 (and NS syn1) pad to 32 rows
    cases = [dict(name=f"w2v_{'hs' if hs else 'ns'}", kind="w2v", mesh={"model": 2},
                  sentences=sents, kwargs=dict(_MESH_KW, hs=hs)) for hs in (False, True)]
    run_world(cases, 2, d)
    return d, sents


@pytest.mark.parametrize("hs", [False, True], ids=["negative-sampling", "hierarchical-softmax"])
def test_word2vec_mesh_matches_unsharded(w2v_world, hs):
    d, sents = w2v_world
    ref = tnlp.Word2Vec(device="cpu", hs=hs, **_MESH_KW).fit(sents)
    for rank in range(2):
        got = result(d, f"w2v_{'hs' if hs else 'ns'}", rank)
        assert got["syn0"].shape == ref.syn0.shape and got["syn1"].shape == ref.syn1.shape
        assert np.array_equal(got["syn0"], ref.syn0), rank
        assert np.array_equal(got["syn1"], ref.syn1), rank


TOL_MLM = 1e-10


def test_bert_mlm_batches_train_the_port_like_jax(tmp_path):
    """``BertIterator``'s MLM batches through a 2-block BERT of hidden 32 in
    float64 (carried over through the JAX zip): the masked score with
    ``masks=[mask]`` and ``label_masks=[lmask]`` equals the JAX graph's to
    ``TOL_MLM`` (relative; float64 in another summation order), and
    ``GraphSolver.fit_batch`` takes the same split, its first score the
    same."""
    from deeplearning4j_tpu.model.serializer import write_model as jax_write
    from deeplearning4j_tpu.model.zoo import BertEncoder as JBert

    from deeplearning4j_tpu_torch.model import restore_computation_graph
    from deeplearning4j_tpu_torch.train.graph_solver import GraphSolver

    jt, tt = _tokenizers()
    sents = [" ".join([_TEXTS[0], _TEXTS[1]]), _TEXTS[3], _TEXTS[4], _TEXTS[0]]
    kw = dict(sentences=sents, max_length=16, batch_size=4, mask_prob=0.4, seed=3)
    jbatch = next(iter(jnlp.BertIterator(jt, task=jnlp.BertTask.UNSUPERVISED, **kw)))
    tbatch = next(iter(tnlp.BertIterator(tt, task=tnlp.BertTask.UNSUPERVISED, **kw)))
    jmodel = JBert(vocab_size=len(_VOCAB), hidden=32, n_layers=2, n_heads=2, ffn_size=64,
                   max_len=16, seed=4, dtype="float64").init()
    path = str(tmp_path / "bert.zip")
    jax_write(jmodel, path)
    model = restore_computation_graph(path, device="cpu")

    def split(mds):
        (ids, mask), (labels,), (lmask,) = mds.features, mds.labels, mds.labels_masks
        return [ids], [labels], [mask], [lmask]

    ids, labels, mask, lmask = split(tbatch)
    jids, jlabels, jmask, jlmask = split(jbatch)
    want = jmodel.score(jids, jlabels, masks=jmask, label_masks=jlmask)
    assert model.score(ids, labels, masks=mask, label_masks=lmask) == pytest.approx(
        want, rel=TOL_MLM)
    solver = GraphSolver(model)
    scores = [float(solver.fit_batch(ids, labels, masks=mask, label_masks=lmask))
              for _ in range(3)]
    assert scores[0] == pytest.approx(want, rel=TOL_MLM) and scores[-1] < scores[0]
