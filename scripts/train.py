#!/usr/bin/env python
"""Training entry point — the reference's ``julia src/train.jl -c cfg -n name``
(``src/train.jl:177-196``) as a CLI over the trainer.

Usage::

    python scripts/train.py -c configs/train_cfg.json -n my_model
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import numpy as np

from admm_deconv.utils.compile_cache import enable_compile_cache

enable_compile_cache()
from admm_deconv.data import DataLoader, ImageDataFeeder
from admm_deconv.models import build_model
from admm_deconv.parallel import distributed
from admm_deconv.train import Trainer, load_config, parse_args


def get_dataloaders(cfg, rng):
    """Per-process loaders: identically-seeded shuffle order across
    processes, each yielding its shard of the global ``cfg.batch_size``."""
    shape = cfg.im_shape
    train_feeder = ImageDataFeeder(
        cfg.train_x_path, cfg.train_y_path, ".png", shape, shape, rng=rng
    )
    eval_feeder = ImageDataFeeder(
        cfg.eval_x_path, cfg.eval_y_path, ".png", shape, shape, rng=rng
    )
    shard = dict(
        process_count=jax.process_count(), process_index=jax.process_index()
    )
    train_loader = DataLoader(
        train_feeder, batch_size=cfg.batch_size, shuffle=True,
        rng=np.random.default_rng(cfg.seed + 1), **shard,
    )
    eval_loader = DataLoader(eval_feeder, batch_size=cfg.batch_size, **shard)
    return train_loader, eval_loader


def main(argv=None):
    args = parse_args(argv)
    if args.coordinator is not None:
        distributed.initialize(
            args.coordinator, args.num_processes, args.process_id
        )
    lead = jax.process_index() == 0
    log = print if lead else (lambda *a, **k: None)
    cfg_path = args.cfg_fname
    if not os.path.isabs(cfg_path) and not os.path.exists(cfg_path):
        cfg_path = os.path.join(os.path.dirname(__file__), "..", "configs", cfg_path)
    log(f"Loading config {cfg_path}")
    cfg = load_config(cfg_path)
    cfg.model_name = args.model_name

    rng = np.random.default_rng(cfg.seed)
    log("Initializing data feeders")
    train_loader, eval_loader = get_dataloaders(cfg, rng)
    if len(train_loader.dataset) == 0:
        raise SystemExit("no training images found — check the config data paths")

    log(f"Building model {cfg.model}")
    model = build_model(cfg.model, {"use_iso": cfg.use_iso, "fft_mode": cfg.fft_mode,
                                    "state_dtype": cfg.state_dtype})
    trainer = Trainer(model, cfg)

    sample_x, _ = next(iter(train_loader))
    state = trainer.init_state(jax.random.PRNGKey(cfg.seed), sample_x)
    n_params = sum(p.size for p in jax.tree_util.tree_leaves(state.params))
    log(f"MODEL SIZE (#parameters): {n_params:,}")

    log("Proceeding with training")
    trainer.fit(state, train_loader, eval_loader, resume=True, tensorboard=True)
    log("DONE")


if __name__ == "__main__":
    main()
