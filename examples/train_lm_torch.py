"""Train a reduced LM (any --arch) with the port's full fault-tolerant
loop: checkpointing, resume, straggler watchdog -- the PyTorch counterpart
of examples/train_lm.py, on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/train_lm_torch.py --arch gemma2-2b --steps 200

A second run with the same ``--ckpt`` resumes from its latest checkpoint.
"""
import argparse
import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import get_spec  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models.module import init_with_axes, param_count  # noqa: E402
from repro_torch.models.transformer import init_lm, lm_loss  # noqa: E402
from repro_torch.training import fault_tolerance as ft  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training.step import make_train_step  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_lm_ckpt_torch"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_spec(args.arch).reduced
    params, _ = init_with_axes(init_lm, 0, cfg, device=dev)
    print(f"{args.arch} (reduced): {param_count(params):,} params on {dev}")

    pipe = synthetic.TokenPipeline(vocab=cfg.vocab, seq_len=args.seq,
                                   batch=args.batch, seed=3)
    ocfg = opt.OptConfig(lr=1e-2, total_steps=args.steps, warmup_steps=10)

    def loss_fn(p, b):
        return lm_loss(p, cfg, torch.as_tensor(b["tokens"], device=dev),
                       torch.as_tensor(b["labels"], device=dev))

    raw_step = make_train_step(loss_fn, ocfg)

    def step_fn(state, batch):
        p, s, metrics = raw_step(state["params"], state["opt"], batch)
        state["params"], state["opt"] = p, s
        return state, metrics

    state = {"params": params, "opt": opt.init_opt_state(params, ocfg),
             "data_state": pipe.init_state(), "step": 0}
    logs = []

    def log(line):
        logs.append(line)
        print(line, flush=True)

    state, metrics, wd = ft.run_loop(
        step_fn, state, pipe, n_steps=args.steps, ckpt_dir=args.ckpt,
        save_every=50, log_every=20, log=log)
    loss = float(metrics["loss"]) if metrics else float("nan")
    print(f"final loss: {loss:.4f}  "
          f"(straggler steps: {wd.slow_steps}, median step {wd.median*1e3:.0f}ms)")
    return {"loss": loss, "step": int(state["step"]),
            "resumed": any("resumed" in line for line in logs),
            "opt_step": int(state["opt"].step)}


if __name__ == "__main__":
    main()
