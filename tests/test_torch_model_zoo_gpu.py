"""The model zoo on the card against the same model on the CPU: reduced
configs, float32 with TF32 off, the weights drawn once on the CPU and
copied to the card.

Held within ``rtol=1e-4, atol=1e-5`` of the CPU: ``loss``, the params
after one ``train_step``, ``prefill`` and two ``decode_step`` calls with
``pos`` a device tensor (decoded under sync-debug "error"), and the
caches; cuBLAS and ATen's CPU kernels sum in other orders. The configs
are the attention + MLP ones and the MoE / recurrent ones (DeepSeekMoE,
Grok-1, Jamba, xLSTM). A federated LM worker's captured training step
(a dense one and a MoE one) is replayed against the same step called
eagerly, bitwise, and two LM workers on equal shards go through
``run_fedpc_scan``, each on its captured step, bitwise equal to
``run_fedpc``. The reference's toggles run on the card too: blocked
attention on the gradient path and the LSTM chunk (16 steps and the naive
loop), loss and gradients against the CPU and the default route, and
five Nesterov momentum steps against the CPU.

Needs a CUDA card; every test here is marked ``gpu`` and skips where
``torch.cuda.is_available()`` is false. It imports nothing of JAX::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_model_zoo_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import BatchIterator
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.fed.simulator import FedSimulator
from repro_torch.fed.worker import Worker, WorkerConfig, make_worker_configs
from repro_torch.models import build_model
from repro_torch.utils import tree_leaves, tree_map

B, S = 2, 32
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _batch(cfg, rng) -> dict:
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))}
    if cfg.mrope:
        batch["positions"] = torch.arange(S, dtype=torch.int32).expand(
            3, B, S).contiguous()
    if cfg.is_encdec:
        batch["audio_embed"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.n_frames, cfg.d_model)).astype(np.float32))
    if cfg.arch_type == "vlm":
        batch["vision_embed"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32))
    return batch


def _close(a, b):
    np.testing.assert_allclose(a.detach().cpu().float().numpy(),
                               b.detach().float().numpy(), **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["fedpc-paper", "qwen3-14b",
                                  "mistral-nemo-12b", "phi4-mini-3.8b",
                                  "whisper-medium", "qwen2-vl-7b",
                                  "deepseek-moe-16b",
                                  "grok-1-314b", "jamba-1.5-large-398b",
                                  "xlstm-350m"])
def test_model_on_card_matches_cpu(cuda, arch):
    cfg = get_config(arch).reduced()
    m = build_model(cfg)
    cpu = m.init(torch.Generator().manual_seed(0), device="cpu")
    card = tree_map(lambda a: a.to(cuda), cpu)
    batch = _batch(cfg, np.random.default_rng(1))
    cbatch = {k: v.to(cuda) for k, v in batch.items()}
    _close(m.loss(card, cbatch)[0], m.loss(cpu, batch)[0])
    outs = [m.train_step(p, m.optimizer.init(p), b, 0.01)
            for p, b in ((card, cbatch), (cpu, batch))]
    for a, b in zip(tree_leaves(outs[0][0]), tree_leaves(outs[1][0])):
        _close(a, b)
    with torch.no_grad():
        states = [m.init_decode_state(B, S + 2, device=d)
                  for d in (cuda, "cpu")]
        runs = [m.prefill(p, b, st) for p, b, st in
                ((card, cbatch, states[0]), (cpu, batch, states[1]))]
        _close(runs[0][0], runs[1][0])
        # two steps fed the prompt's first tokens, uploaded beforehand
        pos = torch.tensor(S, device=cuda)
        ctoks = cbatch["tokens"]
        card_logits = []
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for i in range(2):
                sb = {"token": ctoks[:, i:i + 1], "pos": pos + i}
                if cfg.mrope:
                    sb["positions"] = torch.full((3, B, 1), S + i,
                                                 dtype=torch.int32,
                                                 device=cuda)
                card_logits.append(m.decode_step(card, runs[0][1], sb)[0])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        for i in range(2):
            sb = {"token": batch["tokens"][:, i:i + 1], "pos": S + i}
            if cfg.mrope:
                sb["positions"] = torch.full((3, B, 1), S + i,
                                             dtype=torch.int32)
            _close(card_logits[i], m.decode_step(cpu, runs[1][1], sb)[0])
        for a, b in zip(tree_leaves(runs[0][1]), tree_leaves(runs[1][1])):
            _close(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("optimizer", ["momentum", "adam"])
def test_lm_worker_graph_replay_equals_eager_step(cuda, optimizer):
    _graph_replay_equals_eager_step(cuda, "qwen3-14b", optimizer)


@pytest.mark.gpu
@pytest.mark.parametrize("optimizer", ["momentum", "adam"])
def test_moe_worker_graph_replay_equals_eager_step(cuda, optimizer):
    # routing, dispatch and the router's auxiliaries inside the graph
    _graph_replay_equals_eager_step(cuda, "deepseek-moe-16b", optimizer)


def _graph_replay_equals_eager_step(cuda, arch, optimizer):
    cfg = get_config(arch).reduced()
    m = build_model(cfg)
    params = m.init(torch.Generator().manual_seed(0), device=cuda)
    toks = SyntheticLM(n_sequences=64, seq_len=64, vocab=cfg.vocab,
                       seed=0).generate()
    w = Worker(WorkerConfig(worker_id=0, batch_size=16,
                            optimizer=optimizer),
               BatchIterator((toks,), 16, seed=0), m.loss_and_grad)
    w.opt_state = w.opt.init(params)
    idx = torch.from_numpy(w.round_indices()).to(cuda)
    batches = w.gather(idx)
    step0 = torch.zeros((), dtype=torch.int32, device=cuda)
    ts = w.train_step(params, w.opt_state, batches)
    assert ts.graph is not None
    outs = []
    for replay in (True, False, True):
        ts.load(params, w.opt_state, step0, batches)
        for _ in range(idx.shape[0]):
            ts.graph.replay() if replay else ts()
        outs.append([x.clone() for x in tree_leaves(
            (ts.params, ts.opt_state, ts.step, ts.total))])
    torch.cuda.synchronize()
    for run in outs[1:]:
        for a, b in zip(outs[0], run):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_lm_scan_driver_replays_graphs_and_equals_run_fedpc(cuda):
    # Two reduced qwen3-14b workers on equal shards of 24 sequences at
    # batch 8: run_fedpc_scan trains each through its captured step and
    # equals run_fedpc from the same state, bitwise.
    cfg = get_config("qwen3-14b").reduced()
    m = build_model(cfg)
    toks = SyntheticLM(n_sequences=48, seq_len=32, vocab=cfg.vocab,
                       seed=0).generate()
    shards = np.array_split(np.arange(48), 2)
    cpu = m.init(torch.Generator().manual_seed(0), device="cpu")
    runs, sims = [], []
    for method in ("run_fedpc_scan", "run_fedpc"):
        cfgs = make_worker_configs(2, [24, 24], seed=2, batch_menu=(8,))
        workers = [Worker(cfgs[k], BatchIterator((toks[shards[k]],), 8,
                                                 seed=k), m.loss_and_grad)
                   for k in range(2)]
        sim = FedSimulator(workers, tree_map(lambda a: a.to(cuda), cpu),
                           device=cuda)
        runs.append(getattr(sim, method)(2))
        sims.append(sim)
    for w in sims[0].workers:
        assert w._steps and all(ts.graph is not None
                                for ts in w._steps.values())
    a, b = runs
    assert a.pilot_history == b.pilot_history
    assert a.bytes_per_round == b.bytes_per_round
    assert list(a.costs) == list(b.costs)
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x, y)


def _loss_and_grads(m, params, batch):
    (loss, _), grads = m.loss_and_grad(params, batch)
    return [loss, *tree_leaves(grads)]


@pytest.mark.gpu
@pytest.mark.parametrize("toggle", ["attn_block", "lstm_chunk"])
def test_toggles_on_card_match_cpu(cuda, toggle):
    # Blocked attention on the gradient path (reduced qwen3-14b, 32-key
    # blocks at S = 256) and the LSTM chunk (reduced xlstm-350m at S = 32:
    # 16-step chunks and the naive loop): loss and gradients on the card
    # against the same setting on the CPU, and against the card's default
    # route.
    from repro_torch.models import attention, ssm
    if toggle == "attn_block":
        arch, s, settings, default = "qwen3-14b", 256, (32,), None
        setter, n_layers = attention.set_attn_block, None
    else:
        arch, s, settings, default = "xlstm-350m", 32, (16, None), 64
        setter, n_layers = ssm.set_lstm_chunk, 2
    cfg = get_config(arch).reduced()
    if n_layers:
        cfg = cfg.replace(n_layers=n_layers)
    m = build_model(cfg)
    cpu = m.init(torch.Generator().manual_seed(0), device="cpu")
    card = tree_map(lambda a: a.to(cuda), cpu)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, s)).astype(np.int32))}
    cbatch = {k: v.to(cuda) for k, v in batch.items()}
    base = _loss_and_grads(m, card, cbatch)
    try:
        for value in settings:
            setter(value)
            on_card = _loss_and_grads(m, card, cbatch)
            for a, b in zip(on_card, _loss_and_grads(m, cpu, batch)):
                _close(a, b)
            for a, b in zip(on_card, base):
                _close(a, b.cpu())
    finally:
        setter(default)


@pytest.mark.gpu
def test_nesterov_on_card_matches_cpu(cuda):
    from repro_torch.optim.optimizers import apply_updates, momentum
    rng = np.random.default_rng(2)
    params = {"w": torch.from_numpy(rng.standard_normal((64, 32)).astype(
        np.float32)), "b": torch.from_numpy(rng.standard_normal(32).astype(
            np.float32))}
    grads = [tree_map(lambda p: torch.from_numpy(rng.standard_normal(
        tuple(p.shape)).astype(np.float32)), params) for _ in range(5)]
    opt = momentum(nesterov=True)
    outs = []
    for dev in (cuda, "cpu"):
        p = tree_map(lambda a: a.to(dev), params)
        st = opt.init(p)
        for g in grads:
            u, st = opt.update(tree_map(lambda a: a.to(dev), g), st, p, 0.05)
            p = apply_updates(p, u)
        outs.append(p)
    for a, b in zip(tree_leaves(outs[0]), tree_leaves(outs[1])):
        _close(a, b)
