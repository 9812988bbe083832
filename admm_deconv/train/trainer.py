"""Training harness: jit-compiled train/eval steps, checkpointing, logging.

Covers both reference trainers with one loop (``src/train.jl``,
``src/train_v2.jl``): per-step grad/update, epoch-averaged metric reporting
(loss, GMSD, PSNR, MSE — ``train.jl:128-133``), reduce-LR-on-plateau
(``train.jl:125,159``), best-validation checkpointing with CSV history
(``train.jl:142-169``), selectable GMSD/SSIM/MSE loss and
AdaBelief/AdaMax/Adam optimizers (v1 uses AdaBelief+gmsd ``train.jl:122,191``;
v2 AdaMax+ssim ``train_v2.jl:50,89``).

Deltas from the reference:
  * One fused jit step (forward+backward+update) — the reference runs a
    double forward per step (``train.jl:50-53``) and per-step
    ``GC.gc()/CUDA.reclaim()`` (``train.jl:67-68``); neither has an analogue.
  * Per-step metric sums accumulate ON DEVICE inside the jitted step and
    are fetched once per epoch, and batches are decoded + device_put on a
    background prefetch thread (``train/prefetch.py``) — the reference
    host-syncs 4 metrics per step and loads synchronously between steps
    (``train.jl:57-63``).
  * Orbax checkpoints persist the FULL train state (params, optimizer state,
    step, epoch, RNG) with resume-from-latest — the reference saves
    weights-only and has no loading path (SURVEY.md §5.4).
  * Data-parallel sharding of the batch axis over a device mesh via
    ``NamedSharding`` (no reference counterpart), including multi-host:
    with ``mesh_batch <= 0`` the mesh spans every device of every process,
    each process feeds its local shard of the global batch
    (``parallel.distributed.assemble_global_batch``), GSPMD inserts the
    gradient psums, and only process 0 writes CSV/TensorBoard while Orbax
    checkpointing coordinates across all processes.
"""

from __future__ import annotations

import csv
import os
import re
import time
from functools import partial
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np
import optax
from flax import struct

from admm_deconv.metrics import gmsd_loss, peak_snr, ssim_loss
from admm_deconv.optim.plateau import ReduceLROnPlateau
from admm_deconv.train.config import TrainConfig
from admm_deconv.train.logging import TensorBoardLogger
from admm_deconv.train.prefetch import Prefetcher

try:
    import orbax.checkpoint as ocp

    _HAS_ORBAX = True
except ImportError:  # pragma: no cover
    _HAS_ORBAX = False


LOSSES: dict[str, Callable] = {
    "gmsd": gmsd_loss,
    "ssim": ssim_loss,
    "mse": lambda x, y: jnp.mean((x - y) ** 2),
}

OPTIMIZERS: dict[str, Callable] = {
    "adabelief": optax.adabelief,
    "adamax": lambda lr: optax.adamax(lr, b1=0.9, b2=0.999, eps=1e-8),
    "adam": optax.adam,
}


class TrainState(struct.PyTreeNode):
    """Full resumable train state (params + opt state + counters)."""

    params: Any
    opt_state: Any
    step: jnp.ndarray
    epoch: jnp.ndarray


def _metric_fns():
    return {
        "gmsd": gmsd_loss,
        "psnr": peak_snr,
        "mse": lambda x, y: jnp.mean((x - y) ** 2),
    }


class Trainer:
    """Config-driven training loop for restoration models."""

    def __init__(
        self,
        model,
        config: TrainConfig,
        loss_fn: Callable | None = None,
    ):
        self.model = model
        self.config = config
        self.loss_fn = loss_fn if loss_fn is not None else LOSSES[config.loss]
        opt_factory = OPTIMIZERS[config.optimizer]
        # inject_hyperparams exposes learning_rate in the opt state so the
        # plateau schedule can lower it without rebuilding the optimizer
        # (the reference's rebuild never escapes its function scope —
        # reduce_rl_plateau.jl:43, a documented bug).
        self.optimizer = optax.inject_hyperparams(opt_factory)(
            learning_rate=config.lr_rate
        )
        self.plateau = ReduceLROnPlateau(
            config.lr_rate, config.plateau_patience, config.plateau_factor
        )
        self.mesh = None
        n_data = config.mesh_batch
        if jax.process_count() > 1:
            # Multi-process requires the data mesh to span every device of
            # every process; reject an explicit conflicting setting BEFORE
            # overriding (it would otherwise be silently ignored).
            if n_data > 0 and n_data != jax.device_count():
                raise ValueError(
                    "multi-process training requires the data mesh to span "
                    f"all devices: mesh_batch={config.mesh_batch} but "
                    f"device_count={jax.device_count()}"
                )
            n_data = jax.device_count()
        elif n_data <= 0:
            n_data = jax.device_count()  # all local devices
        if n_data > 1:
            devices = np.array(jax.devices()[:n_data])
            self.mesh = jax.sharding.Mesh(devices, ("data",))
            self.batch_sharding = jax.sharding.NamedSharding(
                self.mesh, jax.sharding.PartitionSpec("data")
            )
            self.replicated = jax.sharding.NamedSharding(
                self.mesh, jax.sharding.PartitionSpec()
            )
        self.is_lead = jax.process_index() == 0

        self._train_step = jax.jit(self._train_step_impl, donate_argnums=(0, 3))
        self._eval_step = jax.jit(self._eval_step_impl, donate_argnums=(3,))

    # ---- jitted step functions -------------------------------------------
    #
    # Metric accumulation happens ON DEVICE inside the jitted step (the
    # ``acc`` running-sum dict rides the jit boundary and is donated):
    # fetching per-step floats would cost 4+ host round-trips per batch.
    # The loop fetches the sums ONCE per epoch.

    def _train_step_impl(self, state: TrainState, x, y, acc):
        def loss_of(params):
            out = self.model.apply(params, x)
            return self.loss_fn(out, y), out

        (loss, out), grads = jax.value_and_grad(loss_of, has_aux=True)(state.params)
        updates, opt_state = self.optimizer.update(
            grads, state.opt_state, state.params
        )
        params = optax.apply_updates(state.params, updates)
        metrics = {"loss": loss}
        for name, fn in _metric_fns().items():
            metrics[name] = fn(out, y)
        new_state = state.replace(
            params=params, opt_state=opt_state, step=state.step + 1
        )
        acc = {k: acc[k] + v for k, v in metrics.items()}
        return new_state, acc

    def _eval_step_impl(self, params, x, y, acc):
        out = self.model.apply(params, x)
        metrics = {"loss": self.loss_fn(out, y)}
        for name, fn in _metric_fns().items():
            metrics[name] = fn(out, y)
        return {k: acc[k] + v for k, v in metrics.items()}

    def _zero_acc(self):
        zeros = {
            k: jnp.zeros(()) for k in ("loss", *_metric_fns().keys())
        }
        if self.mesh is not None:
            zeros = jax.device_put(zeros, self.replicated)
        return zeros

    # ---- state ------------------------------------------------------------

    def init_state(self, rng_key, sample_x) -> TrainState:
        if self.mesh is not None:
            # Params/opt state replicated over the mesh as global arrays —
            # required for multi-process jit inputs, free on one process.
            # Inputs go in as numpy (assumed identical on every process) so
            # the jit sees host values rather than process-local arrays.
            params = jax.jit(self.model.init, out_shardings=self.replicated)(
                np.asarray(rng_key), np.asarray(sample_x)
            )
            opt_state = jax.jit(
                self.optimizer.init, out_shardings=self.replicated
            )(params)
            counters = jax.device_put(
                (np.asarray(0), np.asarray(0)), self.replicated
            )
            return TrainState(
                params=params, opt_state=opt_state,
                step=counters[0], epoch=counters[1],
            )
        params = jax.jit(self.model.init)(rng_key, sample_x)
        opt_state = self.optimizer.init(params)
        # Counters are STRONG int32 (np.asarray): a weak-typed jnp scalar
        # here would flip weak/strong against Orbax-restored (strong)
        # leaves after a resume, and every flip retraces and recompiles the
        # train step (tests pin the trace count).
        return TrainState(
            params=params,
            opt_state=opt_state,
            step=jnp.asarray(np.asarray(0)),
            epoch=jnp.asarray(np.asarray(0)),
        )

    def _rep(self, x):
        """Replicate a host scalar/array over the mesh (multi-process jit
        inputs must be global arrays; a plain ``jnp.asarray`` is local).
        Always STRONG-typed (via numpy) — see ``init_state`` on why weak
        scalars retrace the step after checkpoint resume."""
        if self.mesh is None:
            return jnp.asarray(np.asarray(x))
        return jax.device_put(np.asarray(x), self.replicated)

    def _set_lr(self, state: TrainState, lr: float) -> TrainState:
        """Functionally rebuild the opt state with the new learning rate —
        no in-place pytree mutation (aliasing across TrainState instances
        breaks under sharded/donated opt state)."""
        opt_state = state.opt_state
        hyperparams = dict(opt_state.hyperparams)
        hyperparams["learning_rate"] = self._rep(
            np.asarray(lr, dtype=np.asarray(hyperparams["learning_rate"]).dtype)
        )
        return state.replace(opt_state=opt_state._replace(hyperparams=hyperparams))

    def _shard_batch(self, x, y):
        if self.mesh is None:
            return jnp.asarray(x), jnp.asarray(y)
        if jax.process_count() > 1:
            # x/y are this process's local shard of the global batch; stitch
            # them into one global array sharded over the data axis.
            from admm_deconv.parallel.distributed import assemble_global_batch

            spec = jax.sharding.PartitionSpec("data")
            return (
                assemble_global_batch(np.asarray(x), self.mesh, spec),
                assemble_global_batch(np.asarray(y), self.mesh, spec),
            )
        return (
            jax.device_put(x, self.batch_sharding),
            jax.device_put(y, self.batch_sharding),
        )

    # ---- checkpointing ----------------------------------------------------

    def _ckpt_manager(self, model_dir: str):
        if not _HAS_ORBAX or not self.config.checkpointing:
            return None
        return ocp.CheckpointManager(
            os.path.abspath(os.path.join(model_dir, "checkpoints")),
            options=ocp.CheckpointManagerOptions(
                max_to_keep=self.config.keep_checkpoints, create=True
            ),
        )

    def save_checkpoint(self, manager, state: TrainState, epoch: int) -> None:
        """Asynchronous epoch checkpoint (SURVEY §5.3): Orbax stages the
        (replicated) state and commits in a background thread — in
        multi-host runs all processes coordinate through the
        ``jax.distributed`` client — so training continues immediately.
        ``fit`` calls ``manager.wait_until_finished()`` once at the end; an
        overlapping next save waits for the previous one inside Orbax."""
        if manager is None:
            return
        manager.save(epoch, args=ocp.args.StandardSave(state))

    def save_best(
        self, model_dir: str, state: TrainState, epoch: int,
        eval_metrics: dict[str, float],
    ) -> str | None:
        """Write the best-validation checkpoint under a metric-encoding name,
        replacing the previous best — the reference's
        ``<name>-ep_N-vloss_X-psnr_Y-mse_Z.jld2`` convention
        (``src/train.jl:161-165``), as an Orbax directory."""
        if not _HAS_ORBAX or not self.config.checkpointing:
            return None
        best_root = os.path.abspath(os.path.join(model_dir, "best"))
        os.makedirs(best_root, exist_ok=True)
        name = (
            f"{self.config.model_name}-ep_{epoch}"
            f"-vloss_{eval_metrics.get('loss', float('nan')):.4f}"
            f"-psnr_{eval_metrics.get('psnr', float('nan')):.4f}"
            f"-mse_{eval_metrics.get('mse', float('nan')):.6f}"
        )
        path = os.path.join(best_root, name)
        ckpt = ocp.StandardCheckpointer()
        ckpt.save(path, state)
        ckpt.wait_until_finished()
        if self.is_lead:  # filesystem cleanup belongs to one process
            for prev in os.listdir(best_root):
                if prev != name:
                    import shutil

                    shutil.rmtree(os.path.join(best_root, prev), ignore_errors=True)
        return path

    @staticmethod
    def _parse_best_name(name: str) -> tuple[float, int] | None:
        """Extract (vloss, epoch) from a metric-encoding checkpoint name."""
        m = re.search(r"-ep_(\d+)-vloss_([0-9.natinf+-]+?)-psnr_", name)
        if m is None:
            return None
        try:
            return float(m.group(2)), int(m.group(1))
        except ValueError:
            return None

    def _canonicalize_restored(self, state):
        """Normalize Orbax-restored arrays to the FRESH-state signature.

        Restored leaves are device-COMMITTED; fresh jit outputs and the
        loop's host-inserted values (``_rep``/``_zero_acc``) are not, and
        committed-ness is part of the jit executable cache key — without
        this, a resumed single-device run cycles through 3 signatures
        (restored-committed, all-committed outputs, mixed after the epoch
        boundary), i.e. 3 full train-step recompiles.  The host round-trip strips commitment; the mesh path is
        already consistently committed (everything rides device_put with
        NamedShardings) and must not be round-tripped (non-addressable
        shards in multi-process runs).
        """
        if state is None or self.mesh is not None:
            return state
        return jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a)) if isinstance(a, jax.Array) else a,
            state,
        )

    def restore_best(self, model_dir: str, template: TrainState) -> TrainState | None:
        """Load the metric-named best checkpoint (the loading path the
        reference lacks entirely, SURVEY.md §5.4); None if absent.

        ``save_best`` deletes the previous best, but a crash between save
        and cleanup can leave several entries — so the choice is by the
        LOWEST encoded validation loss (newest epoch as tiebreak), not
        directory order.
        """
        best_root = os.path.abspath(os.path.join(model_dir, "best"))
        if not _HAS_ORBAX or not os.path.isdir(best_root):
            return None
        entries = sorted(os.listdir(best_root))
        if not entries:
            return None
        parsed = [(self._parse_best_name(e), e) for e in entries]
        scored = [
            (vloss, -ep, e) for (p, e) in parsed if p is not None
            for (vloss, ep) in [p]
        ]
        best = min(scored)[2] if scored else entries[-1]
        return self._canonicalize_restored(
            ocp.StandardCheckpointer().restore(
                os.path.join(best_root, best), template
            )
        )

    def restore_latest(self, model_dir: str, template: TrainState) -> tuple[TrainState, int]:
        """Resume from the newest checkpoint under ``model_dir`` (no-op if
        none exist).  Returns (state, start_epoch)."""
        manager = self._ckpt_manager(model_dir)
        if manager is None or manager.latest_step() is None:
            return template, 0
        restored = manager.restore(
            manager.latest_step(), args=ocp.args.StandardRestore(template)
        )
        return self._canonicalize_restored(restored), int(manager.latest_step()) + 1

    # ---- the loop ----------------------------------------------------------

    def fit(
        self,
        state: TrainState,
        train_loader,
        eval_loader,
        epochs: int | None = None,
        model_dir: str | None = None,
        log_fn: Callable[[str], None] = print,
        resume: bool = False,
        tensorboard: bool = False,
    ) -> TrainState:
        cfg = self.config
        epochs = epochs if epochs is not None else cfg.epochs
        model_dir = model_dir or os.path.join(cfg.save_dir, cfg.model_name)
        os.makedirs(model_dir, exist_ok=True)
        history_path = os.path.join(model_dir, "train_eval_metrics_history.csv")
        manager = self._ckpt_manager(model_dir)
        tb = (
            TensorBoardLogger(os.path.join(model_dir, "logging"))
            if tensorboard and self.is_lead
            else None
        )

        start_epoch = 0
        if resume:
            state, start_epoch = self.restore_latest(model_dir, state)
            if start_epoch:
                log_fn(f"resumed from epoch {start_epoch}")

        # A resumed run continues the pre-crash history and best-checkpoint
        # bar instead of clobbering them (the reference kept full history
        # across epochs, ``src/train.jl:142-148,167-169``): completed rows
        # are reloaded from the CSV — every process reads it (shared
        # filesystem, as Orbax multi-host already requires) so best/plateau
        # decisions stay consistent — and best_val_loss resumes from the
        # lowest recorded eval loss, so a worse post-resume epoch cannot
        # displace the pre-crash best checkpoint.
        best_val_loss = float("inf")
        history: list[dict[str, float]] = []
        if resume and start_epoch and os.path.exists(history_path):
            with open(history_path, newline="") as f:
                rows = list(csv.DictReader(f))
            history = [
                {k: float(v) for k, v in r.items()}
                for r in rows
                if r.get("epoch") and int(float(r["epoch"])) < start_epoch
            ]
            losses = [h["eval_loss"] for h in history if "eval_loss" in h]
            if losses:
                best_val_loss = min(losses)
                # The plateau tracker is deterministic in the loss sequence:
                # replaying the recorded epochs restores its patience counter
                # and reduced LR exactly (it would otherwise restart at the
                # config LR and overwrite the checkpoint's restored LR).
                for loss_v in losses:
                    self.plateau.step(loss_v)

        # Batches are decoded + device_put on a background thread so input
        # work overlaps the (async-dispatched) device step; metric sums stay
        # on device until the end of each epoch (see the step functions).
        prefetch = max(int(getattr(cfg, "prefetch_batches", 2)), 0)

        def batches(loader):
            if prefetch == 0:
                for x, y in loader:
                    yield self._shard_batch(x, y)
            else:
                yield from Prefetcher(
                    loader, transform=self._shard_batch, depth=prefetch
                )

        for epoch in range(start_epoch, epochs):
            t0 = time.time()
            acc = self._zero_acc()
            n_train = 0
            for x, y in batches(train_loader):
                state, acc = self._train_step(state, x, y, acc)
                n_train += 1
            train_metrics = {
                k: float(v) / max(n_train, 1) for k, v in acc.items()
            }

            acc = self._zero_acc()
            n_eval = 0
            for x, y in batches(eval_loader):
                acc = self._eval_step(state.params, x, y, acc)
                n_eval += 1
            eval_metrics = {k: float(v) / max(n_eval, 1) for k, v in acc.items()}

            val_loss = eval_metrics.get("loss", float("inf"))
            # Metrics are replicated jit outputs, so every process computes
            # the same val_loss and takes the same plateau/best decisions —
            # no broadcast needed.
            new_lr = self.plateau.step(val_loss)
            state = self._set_lr(state, new_lr)
            state = state.replace(epoch=self._rep(epoch + 1))

            row = {
                "epoch": epoch,
                **{f"train_{k}": v for k, v in train_metrics.items()},
                **{f"eval_{k}": v for k, v in eval_metrics.items()},
                "lr": new_lr,
                "seconds": time.time() - t0,
            }
            first_row = not history
            history.append(row)
            if self.is_lead:
                # Rewrite once on the first row of this run (prunes any
                # partial post-crash rows after a resume), then append.
                mode = "w" if first_row or epoch == start_epoch else "a"
                with open(history_path, mode, newline="") as f:
                    writer = csv.DictWriter(f, fieldnames=list(history[0].keys()))
                    if mode == "w":
                        writer.writeheader()
                        writer.writerows(history)
                    else:
                        writer.writerow(row)

            if tb is not None:
                tb.log_scalars(train_metrics, epoch, prefix="train/")
                tb.log_scalars(eval_metrics, epoch, prefix="eval/")
                tb.log_scalars({"lr": new_lr}, epoch)
                tb.log_histograms(state.params, epoch)
                tb.flush()

            if (epoch + 1) % cfg.checkpoint_every == 0 or val_loss < best_val_loss:
                self.save_checkpoint(manager, state, epoch)
            if val_loss < best_val_loss:
                self.save_best(model_dir, state, epoch, eval_metrics)
                best_val_loss = val_loss

            if self.is_lead:
                log_fn(
                    f"[epoch {epoch}] "
                    + " ".join(f"train_{k}={v:.5f}" for k, v in train_metrics.items())
                    + " | "
                    + " ".join(f"eval_{k}={v:.5f}" for k, v in eval_metrics.items())
                    + f" | lr={new_lr:.2e} ({row['seconds']:.1f}s)"
                )

        if tb is not None:
            tb.close()
        if manager is not None:
            manager.wait_until_finished()  # drain async epoch saves
        return state
