"""One rank of ``tests/test_torch_parallel.py``'s data-parallel runs.

``python tests/torch_dp_worker.py <dir>`` in each rank, with ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` set as
torchrun sets them: joins a gloo group on the CPU, reads
``<dir>/inputs.pt``, runs ``run`` and writes ``<dir>/rank<r>.pt``. The
process cannot import jax, flax or the JAX package. The test calls
``run`` itself for the single-process side.
"""

import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _step_runs(config, params, batch, vocab, world, steps):
    """``steps`` port train steps from ``params`` on ``batch``: each step's
    metrics, gradients (as summed over the ranks) and parameters after."""
    from gluon_e2e_asr_tpu_torch.models.asr import build_model
    from gluon_e2e_asr_tpu_torch.training import train_step as T

    V, sos, eos = vocab
    model = build_model(config, V, train=True, sos_id=sos, eos_id=eos)
    model.load_state_dict(params)
    opt = T.make_optimizer(config)
    state = T.TrainState(step=0, opt_state=opt.init(dict(model.named_parameters())),
                         generator=torch.Generator().manual_seed(1))
    fn = T.make_train_step(model, config, opt, world=world)
    out = []
    for _ in range(steps):
        m = fn(state, batch)
        out.append({
            "metrics": {k: float(v) for k, v in m.items()},
            "grads": {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                      .detach().numpy().copy()
                      for k, p in model.named_parameters()},
            "params": {k: v.detach().numpy().copy()
                       for k, v in model.state_dict().items()}})
    return out, model


def _accum_runs(config, params, batch, vocab, world, groups=2):
    """``groups`` updates at ``accum_grad_steps=2`` (make_grad_step on each
    half of ``batch``, one Accumulator update), with encoder dropout on:
    each update's metrics and the parameters after it."""
    import copy

    from gluon_e2e_asr_tpu_torch.models.asr import build_model
    from gluon_e2e_asr_tpu_torch.training import train_step as T

    config = copy.deepcopy(config)
    config.model.enc_dropout = 0.1
    V, sos, eos = vocab
    model = build_model(config, V, train=True, sos_id=sos, eos_id=eos)
    model.load_state_dict(params)
    opt = T.make_optimizer(config)
    state = T.TrainState(step=0, opt_state=opt.init(dict(model.named_parameters())),
                         generator=torch.Generator().manual_seed(1))
    grad_fn = T.make_grad_step(model, config, world=world)
    acc = T.Accumulator(model, opt, world)
    half = batch["audio"].shape[0] // 2
    out = []
    for _ in range(groups):
        for rows in (slice(0, half), slice(half, None)):
            acc.add(*grad_fn(state, {k: v[rows] for k, v in batch.items()}))
        m = acc.apply(state)
        out.append({"metrics": {k: float(v) for k, v in m.items()},
                    "params": {k: v.detach().numpy().copy()
                               for k, v in model.state_dict().items()}})
    return out


def _resume_runs(config, workdir, world):
    """At train.dp over ``world``: an uninterrupted trainer run, and a run
    stopped mid-epoch by max_steps and resumed by a fresh trainer from
    its checkpoint (rank 0 writes it; every rank reads it after a
    barrier). Both runs' parameters and steps."""
    import copy

    from gluon_e2e_asr_tpu_torch.training.trainer import Trainer

    out = {}
    for name, max_steps in (("ref", -1), ("cut", 3)):
        c = copy.deepcopy(config)
        c.train.max_steps = max_steps
        t = Trainer(c, workdir=os.path.join(workdir, name))
        t.train()
        world.barrier()
        if name == "cut":
            t = Trainer(copy.deepcopy(config), workdir=os.path.join(workdir, name))
            t.maybe_resume()
            out["resumed_at"] = (t.state.step, t.epoch0, t.skip_batches)
            t.train()
        out[name] = {"step": t.state.step,
                     "params": {k: v.detach().numpy().copy()
                                for k, v in t.model.state_dict().items()}}
    return out


def run(inputs, world):
    """The runs the test compares across world sizes."""
    from gluon_e2e_asr_tpu_torch.data.tokenizer import CharTokenizer
    from gluon_e2e_asr_tpu_torch.decoding.beam import make_beam_decoder
    from gluon_e2e_asr_tpu_torch.decoding.greedy import make_greedy_decoder
    from gluon_e2e_asr_tpu_torch.models.asr import build_model

    torch.manual_seed(0)
    vocab = inputs["vocab"]
    out = {}
    out["stochastic"], _ = _step_runs(inputs["config"], inputs["params"],
                                      inputs["batch"], vocab, world, 2)
    out["pad_shard"], _ = _step_runs(inputs["config"], inputs["params"],
                                     inputs["pad_batch"], vocab, world, 1)
    out["accum"] = _accum_runs(inputs["config"], inputs["params"],
                               inputs["batch"], vocab, world)
    if world.size > 1:
        out["resume"] = _resume_runs(inputs["resume_config"],
                                     inputs["resume_dir"], world)
    out["deterministic"], _ = _step_runs(inputs["det_config"],
                                         inputs["det_params"],
                                         inputs["det_batch"], vocab, world, 1)
    config = inputs["decode_config"]
    model = build_model(config, vocab[0], sos_id=vocab[1], eos_id=vocab[2])
    model.load_state_dict(inputs["det_params"])
    model.eval()
    audio, audio_len = (inputs["det_batch"][k] for k in ("audio", "audio_len"))
    greedy = make_greedy_decoder(model, config, mesh=world)
    ids, lens = greedy(audio, audio_len)
    beam = make_beam_decoder(model, config, CharTokenizer(), mesh=world)
    texts, scores = beam(audio, audio_len)
    out["decode"] = {"ids": ids.numpy(), "lens": lens.numpy(),
                     "texts": texts, "scores": np.asarray(scores),
                     "nbest": beam.nbest(audio, audio_len),
                     "last_steps": beam.last_steps}
    # the beam with LM shallow fusion: each rank fuses its own rows
    import copy

    from gluon_e2e_asr_tpu_torch.models.lm import LSTMLM

    lm = LSTMLM(vocab[0], *inputs["lm_dims"])
    lm.load_state_dict(inputs["lm_params"])
    lm_config = copy.deepcopy(config)
    lm_config.decode.lm_weight = 0.5
    fused = make_beam_decoder(model, lm_config, CharTokenizer(), mesh=world,
                              lm_bundle=lm)
    lm_texts, lm_scores = fused(audio, audio_len)
    out["decode"].update(lm_texts=lm_texts, lm_scores=np.asarray(lm_scores))
    return out


def main(workdir):
    for name in ("jax", "flax", "gluon_e2e_asr_tpu"):
        sys.modules[name] = None
    sys.path.insert(0, REPO)
    torch.set_num_threads(1)
    from gluon_e2e_asr_tpu_torch.parallel.mesh import init_data_parallel

    world = init_data_parallel("cpu")
    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    out = run(inputs, world)
    out["world"] = (world.rank, world.size)
    torch.save(out, os.path.join(workdir, f"rank{world.rank}.pt"))


if __name__ == "__main__":
    main(sys.argv[1])
