"""Multi-host tests: single-process helper checks plus a REAL 2-process
``jax.distributed`` CPU run (Gloo collectives) exercising initialize,
local_batch_slice, assemble_global_batch, per-process DataLoader sharding,
and an end-to-end multi-process ``Trainer.fit`` (tests/_dist_worker.py).

The reference has no distributed code at all (SURVEY.md §5.8); this is the
first-class component BASELINE's multi-host configs require.
"""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

from admm_deconv.data.feeder import DataLoader
from admm_deconv.parallel import distributed

REPO = os.path.join(os.path.dirname(__file__), "..")


class TestDistributedHelpers:
    def test_single_process(self):
        assert not distributed.is_multi_host()
        assert jax.process_count() == 1

    def test_local_batch_slice(self):
        s = distributed.local_batch_slice(8)
        assert s == slice(0, 8)

    def test_indivisible_batch_rejected(self):
        import unittest.mock as mock

        with mock.patch.object(jax, "process_count", return_value=2):
            with pytest.raises(ValueError):
                distributed.local_batch_slice(7)


class _Pairs:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, idxs):
        idxs = np.asarray(idxs)
        x = np.stack([np.full((4, 4, 1), i, np.float32) for i in idxs])
        return x, x


class TestProcessShardedLoader:
    """Single-process checks of the loader's multi-process contract."""

    def test_shards_partition_each_batch(self):
        # Two identically-seeded loaders (one per simulated process) must
        # together yield exactly the global batch, disjointly.
        loaders = [
            DataLoader(
                _Pairs(8), batch_size=4, shuffle=True,
                rng=np.random.default_rng(7),
                process_count=2, process_index=i,
            )
            for i in range(2)
        ]
        for (x0, _), (x1, _) in zip(*loaders):
            assert x0.shape[0] == 2 and x1.shape[0] == 2
            ids = {int(v) for v in np.concatenate([x0, x1]).reshape(4, -1)[:, 0]}
            assert len(ids) == 4  # disjoint shards covering the global batch

    def test_ragged_final_batch_dropped(self):
        loader = DataLoader(
            _Pairs(7), batch_size=4, process_count=2, process_index=0
        )
        assert len(loader) == 1
        assert sum(1 for _ in loader) == 1

    def test_indivisible_global_batch_rejected(self):
        with pytest.raises(ValueError):
            DataLoader(_Pairs(8), batch_size=3, process_count=2)

    def test_bad_process_index_rejected(self):
        with pytest.raises(ValueError):
            DataLoader(_Pairs(8), batch_size=4, process_count=2, process_index=2)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class TestTwoProcess:
    """Spawn 2 real processes; Gloo CPU collectives between them."""

    def test_two_process_end_to_end(self, tmp_path):
        port = _free_port()
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)  # worker sets its own 2-device flag
        procs = [
            subprocess.Popen(
                [sys.executable, os.path.join(REPO, "tests", "_dist_worker.py"),
                 str(i), "2", str(port), str(tmp_path)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                env=env, text=True,
            )
            for i in range(2)
        ]
        outs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
            outs.append(out)
        for i, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"process {i} failed:\n{out}"

        # CSV history written by the lead process only.
        assert (tmp_path / "run" / "train_eval_metrics_history.csv").exists()
        # Final params identical across processes (replicated train state).
        sums = [
            (tmp_path / f"checksum_{i}.txt").read_text() for i in range(2)
        ]
        assert sums[0] == sums[1], sums
        # Multi-process async Orbax checkpointing: both processes restored
        # the coordinated checkpoint to the exact final params.
        restored = [
            (tmp_path / f"restored_{i}.txt").read_text() for i in range(2)
        ]
        assert restored[0] == restored[1] == sums[0], (restored, sums)
        assert (tmp_path / "run" / "checkpoints").is_dir()
