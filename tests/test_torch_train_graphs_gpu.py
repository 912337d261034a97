"""Training from CUDA graphs on the card (marked `gpu`; they skip without
one, and import nothing of JAX): a tiny BERT classifier with dropout 0.1,
fused AdamW and bf16 trained graphed (the default on a CUDA device) and
eagerly (`eager_programs()`), bitwise equal in losses and parameters
with the same launches a step, with `steps_per_run=4` and with host
batches too; and one captured dropout pass replayed under two step
seeds, each mask the plain version's for its seed.

Deterministic algorithms are on for the fits: the token-type embedding's
backward (one id for every token) sums with atomics otherwise, and two
eager fits differ in its last bits.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.compile_cache import eager_programs
from analytics_zoo_tpu_torch.kernels import LAUNCHES
from analytics_zoo_tpu_torch.kernels import dropout as dr
from analytics_zoo_tpu_torch.kernels import philox
from analytics_zoo_tpu_torch.models.bert import BERTClassifier
from analytics_zoo_tpu_torch.ops import objectives, optimizers

TINY = dict(vocab=512, hidden_size=128, n_block=2, n_head=2, seq_len=64,
            intermediate_size=256)


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and the CUDA kernels "
                    "have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture
def deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(was)


def _fit(eager: bool, **kw):
    rs = np.random.RandomState(0)
    x = [rs.randint(0, 512, (64, 64)).astype(np.int32),
         np.ones((64, 64), np.float32)]
    y = rs.randint(0, 2, (64,)).astype(np.int32)
    m = BERTClassifier(2, use_flash=True, device="cuda", **TINY,
                       hidden_drop=0.1, attn_drop=0.1, dropout=0.1)
    m.ensure_built(x, seed=3)
    m.compile(optimizer=optimizers.fused_adam(1e-3, weight_decay=1e-2),
              loss=objectives.get("sparse_categorical_crossentropy",
                                  from_logits=True))
    LAUNCHES.reset()
    fit_kw = dict(batch_size=8, nb_epoch=2, mixed_precision=True,
                  fused_optimizer=True, **kw)
    if eager:
        with eager_programs():
            h = m.fit(x, y, **fit_kw)
    else:
        h = m.fit(x, y, **fit_kw)
    torch.cuda.synchronize()
    entry = m.__dict__["_train_cache"][1]
    graphs = [p.program.graph is not None for p in entry.programs.values()]
    return (h["loss"], [v.clone() for v in m.state_dict().values()],
            LAUNCHES.snapshot(), graphs)


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [{}, {"steps_per_run": 4},
                                {"device_cache": False}])
def test_graphed_fit_is_bitwise_the_eager_fit_on_gpu(kw, deterministic):
    _need_gpu()
    want = _fit(True, **kw)
    got = _fit(False, **kw)
    assert not any(want[3]) and got[3] and all(got[3])
    assert got[0] == want[0]
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    assert got[2] == want[2] and got[2]["fused_adam"] == 16


@pytest.mark.gpu
def test_replays_read_each_step_seed_on_gpu():
    _need_gpu()
    x = torch.randn(64, 257, device="cuda")
    base = torch.zeros(1, dtype=torch.int64, device="cuda")
    seed = philox.DeviceSeed(base, (1, 4))
    dr.dropout_apply(x, 0.2, seed)
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = dr.dropout_apply(x, 0.2, seed)
    masks = []
    for step_seed in (17, 18):
        base.fill_(step_seed)
        graph.replay()
        torch.cuda.synchronize()
        site = philox.site_seed(philox.site_seed(step_seed, 1), 4)
        keep = dr.dropout_keep(x.shape, site, 0.2, x.device)
        assert torch.equal(out, dr._reference_dropout(x, 0.2, keep))
        masks.append(keep)
    assert not torch.equal(masks[0], masks[1])
