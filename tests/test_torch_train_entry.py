"""The trainer's entry points on the configurations this slice unlocks, on
the CPU at a tiny size: ``train.main`` on ``ucf101_train.yaml`` (class
labels), ``ffs_img_train.yaml`` (LatteIMG with still images) and
``ucf101_img_train.yaml`` (both, with ``y_image``), each for 2 steps,
checkpointed and resumed; their synthetic batches against the JAX
trainer's; and the ``Trainer`` facade's ``fit`` and ``resume``. Everything
written goes to tmp_path.
"""

import logging
import os

import numpy as np
import pytest
import torch

from latte_tpu.config import load_config as jax_load_config
from latte_tpu.train.train import make_batch_iterator as jax_make_batch_iterator
from latte_tpu.train.trainer import Trainer as JaxTrainer
from latte_tpu_torch.config import load_config
from latte_tpu_torch.models import LatteIMG
from latte_tpu_torch.train import train
from latte_tpu_torch.train.callbacks import Callback
from latte_tpu_torch.train.checkpoint import latest_checkpoint, load_checkpoint
from latte_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {
    "ucf101_train": os.path.join(REPO, "configs", "ucf101", "ucf101_train.yaml"),
    "ffs_img_train": os.path.join(REPO, "configs", "ffs", "ffs_img_train.yaml"),
    "ucf101_img_train": os.path.join(REPO, "configs", "ucf101", "ucf101_img_train.yaml"),
}
TINY = ["image_size=32", "num_frames=2", "num_classes=7", "local_batch_size=2", "log_every=1",
        "learning_rate=1e-3", "model_overrides={depth: 2, hidden_size: 32, num_heads: 2}"]


def _tiny(name):
    """TINY, with 2 still images for the image configs (8 as shipped)."""
    return TINY + (["use_image_num=2"] if name.endswith("_img_train") else [])


TABLE = "y_embedder.embedding_table.weight"


def _cfg(name, tmp_path, *extra):
    return load_config(CONFIGS[name], _tiny(name) + [f"results_dir={tmp_path}/results", *extra])


class Snapshot(Callback):
    """The state at the start, and the parameters as they were then."""

    def on_train_start(self, config, state, experiment_dir):
        self.state = state
        self.start = {n: p.detach().clone() for n, p in state.model.named_parameters()}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_cli_trains_checkpoints_and_resumes(name, tmp_path):
    """2 steps as shipped (at a tiny size), a checkpoint at step 2, then a
    resume that starts from it and runs step 3. The class-conditional
    configs train their label table; the image configs build LatteIMG with
    the config's still images."""
    out = train.cli(["--config", CONFIGS[name], "--device", "cpu", *_tiny(name),
                     f"results_dir={tmp_path}/results", "max_train_steps=2", "ckpt_every=2"])
    assert out["final_step"] == 2 and np.isfinite(out["loss"]) and np.isfinite(out["grad_norm"])
    ckpt = latest_checkpoint(os.path.join(out["experiment_dir"], "checkpoints"))
    payload = load_checkpoint(ckpt)
    assert payload["step"] == 2 and payload["args"]["model"] == load_config(CONFIGS[name]).model

    cb = Snapshot()
    resumed = train.main(_cfg(name, tmp_path, "max_train_steps=3", f"resume_from_checkpoint={ckpt}"),
                         callbacks=[cb], device="cpu")
    assert resumed["final_step"] == 3 and cb.state.step == 3
    for n, v in payload["model"].items():
        assert torch.equal(cb.start[n], v), n
    model = cb.state.model
    assert isinstance(model, LatteIMG) == name.endswith("_img_train")
    if isinstance(model, LatteIMG):
        assert model.use_image_num == 2
    class_conditional = name.startswith("ucf101")
    assert (TABLE in cb.start) == class_conditional
    if class_conditional:  # the labels reached the model
        assert not torch.equal(model.get_parameter(TABLE).detach(), cb.start[TABLE])


@pytest.mark.parametrize("name, extra", [
    ("ucf101_train", []), ("ucf101_img_train", []), ("ucf101_train", ["synthetic_kind=pixels"]),
], ids=["ucf101_latents", "ucf101_img_latents", "ucf101_pixels"])
def test_synthetic_batches_match_jax(name, extra):
    """With no ``data_path`` both trainers draw the same synthetic batches
    from ``global_seed``: latents or pixels of F + I frames, then ``y`` in
    [0, num_classes), then ``y_image`` (B, I) under ``use_image_num``."""
    over = _tiny(name) + ["data_path=/nonexistent", "global_seed=3", *extra]
    log = logging.getLogger("test")
    it, kind = train.make_batch_iterator(load_config(CONFIGS[name], over), log, 2)
    jit, jkind = jax_make_batch_iterator(jax_load_config(CONFIGS[name], over), log, 2)
    assert kind == jkind
    images = 2 if name.endswith("_img_train") else 0
    for _ in range(2):
        got, want = next(it), next(jit)
        assert set(got) == set(want) == {"latents" if not extra else "video", "y"} | (
            {"y_image"} if images else set())
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        assert got["y"].shape == (2,) and got["y"].max() < 7
        assert (got.get("latents", got.get("video"))).shape[1] == 2 + images
        if images:
            assert got["y_image"].shape == (2, images)


def test_trainer_fit_and_resume(tmp_path):
    """``Trainer.fit`` trains ucf101_train.yaml (a path) for 2 steps with
    its overrides and callbacks; ``Trainer.resume`` carries on from the
    checkpoint to a third step. Its config resolves as the JAX facade's."""
    cfg = _cfg("ucf101_train", tmp_path)
    kw = dict(max_steps=2, ckpt_every=2, log_every=1, results_dir=str(tmp_path / "facade"))
    cb = Snapshot()
    trainer = Trainer(callbacks=[cb], device="cpu", **kw)
    assert trainer._resolve(CONFIGS["ucf101_train"]) == JaxTrainer(**kw)._resolve(CONFIGS["ucf101_train"])
    out = trainer.fit(cfg)
    assert out["final_step"] == 2 and out["experiment_dir"].startswith(str(tmp_path / "facade"))
    ckpt = latest_checkpoint(os.path.join(out["experiment_dir"], "checkpoints"))
    again = Trainer(max_steps=3, log_every=1, results_dir=str(tmp_path / "facade"), callbacks=[cb],
                    device="cpu").resume(cfg, ckpt)
    assert again["final_step"] == 3 and cb.state.step == 3
    if not torch.cuda.is_available():  # cuda unless asked for the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(max_steps=1, results_dir=str(tmp_path / "gpu")).fit(cfg)
