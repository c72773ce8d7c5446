"""The port's HF ``Trainer`` flash-checkpoint front-end
(``trainer/hf_flash.py``), mirroring the reference's tests
(``tests/test_hf_flash.py``): a snapshot and restore of torch state
dicts through the engine (model and AdamW moments bit for bit, each
restored tensor on the device of the one it replaces), an end-to-end run
under the real ``transformers.Trainer`` on a locally built tiny model,
then a fresh model and callback over the same flash dir that resume the
last flash save (the kill and resume), and bf16 bit for bit. Across the
packages: the same HF run under each package's callback restores the
same model, optimizer and scheduler state. Nothing is downloaded.

Each test gets its own job name and socket dir and unlinks its shm
segments."""

import tests.torch_threads  # noqa: F401  (caps torch's CPU pool)
import os
import uuid

import numpy as np
import pytest
import torch

from dlrover_tpu.trainer import hf_flash as jax_hf_flash
from dlrover_tpu.trainer import runtime as jax_runtime
from dlrover_tpu_torch.flash_ckpt.checkpointer import Checkpointer
from dlrover_tpu_torch.trainer import runtime
from dlrover_tpu_torch.trainer.hf_flash import (
    FlashCkptCallback,
    restore_training_state,
    snapshot_training_state,
)


@pytest.fixture(autouse=True)
def job(monkeypatch, tmp_path):
    name = f"hf{os.getpid()}_{uuid.uuid4().hex[:10]}"
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", name)
    monkeypatch.setenv("DLROVER_TPU_SHARED_DIR", str(tmp_path / "uds"))
    monkeypatch.setenv("DLROVER_TPU_NODE_RANK", "0")
    runtime._context = None
    jax_runtime._context = None
    yield name
    runtime._context = None
    jax_runtime._context = None
    for seg in os.listdir("/dev/shm"):
        if name in seg:
            os.unlink(os.path.join("/dev/shm", seg))


def make_model():
    torch.manual_seed(0)
    return torch.nn.Sequential(
        torch.nn.Linear(4, 8), torch.nn.ReLU(), torch.nn.Linear(8, 2))


def _stepped(model):
    """AdamW and a LambdaLR after one step, so the moments exist."""
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0 / (s + 1))
    model(torch.ones(2, 4)).sum().backward()
    opt.step()
    sched.step()
    return opt, sched


def _flat(tree, prefix=""):
    """(path, leaf) pairs of a nested state dict."""
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _flat(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}{i}.")
    else:
        yield prefix, tree


def _assert_same_state(a, b):
    """Two state dicts equal leaf for leaf: tensors bit for bit, in the
    same dtype and on the same device, other values equal."""
    fa, fb = list(_flat(a)), list(_flat(b))
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        if isinstance(x, torch.Tensor):
            assert isinstance(y, torch.Tensor), path
            assert x.dtype == y.dtype and x.device == y.device, path
            assert torch.equal(x.view(torch.uint8) if x.dim() else x, y.view(
                torch.uint8) if y.dim() else y), path
        else:
            assert x == y, path


def test_snapshot_restore_round_trip(tmp_path):
    model = make_model()
    opt, sched = _stepped(model)
    snap = snapshot_training_state(model, opt, sched)
    ckpt = Checkpointer(str(tmp_path / "ckpt"), standalone=True)
    ckpt.save_checkpoint(5, snap)
    _, loaded, _ = ckpt.load_checkpoint()
    ckpt.close()

    model2 = make_model()
    with torch.no_grad():
        for p in model2.parameters():
            p.add_(1.0)
    opt2, sched2 = _stepped(model2)
    restore_training_state(loaded, model2, opt2, sched2)
    for a, b in zip(model.parameters(), model2.parameters()):
        assert torch.equal(a, b)
    _assert_same_state(opt.state_dict(), opt2.state_dict())
    assert sched.state_dict() == sched2.state_dict()


def _toy_trainer(transformers, out_dir, model, callback, max_steps,
                 save_steps=None):
    from torch.utils.data import Dataset

    gen = torch.Generator().manual_seed(3)
    xs = torch.randn(16, 4, generator=gen)

    class Toy(Dataset):
        def __len__(self):
            return 16

        def __getitem__(self, i):
            return {"x": xs[i], "labels": (xs[i].sum() > 0).long()}

    kw = dict(save_steps=save_steps, save_strategy="steps") if save_steps \
        else {}
    args = transformers.TrainingArguments(
        output_dir=str(out_dir), per_device_train_batch_size=4,
        max_steps=max_steps, report_to=[], use_cpu=True,
        disable_tqdm=True, **kw)
    return args, transformers.Trainer(model=model, args=args,
                                      train_dataset=Toy(),
                                      callbacks=[callback])


class ToyModel(torch.nn.Module):
    def __init__(self):
        super().__init__()
        torch.manual_seed(1)
        self.net = torch.nn.Linear(4, 2)

    def forward(self, x=None, labels=None):
        logits = self.net(x)
        loss = torch.nn.functional.cross_entropy(logits, labels)
        return {"loss": loss, "logits": logits}


def _hf_run_and_resume(transformers, tmp_path, callback_cls, tag):
    """Train 4 steps saving every 2 under ``callback_cls``, close it (the
    kill), then resume a fresh zeroed model, optimizer and scheduler
    through a fresh callback's ``on_train_begin``. Returns the trained
    state, the resumed one and the resumed global step."""
    flash = str(tmp_path / f"flash_{tag}")
    cb = callback_cls(flash)
    _, trainer = _toy_trainer(transformers, tmp_path / f"hf_{tag}",
                              ToyModel(), cb, max_steps=4, save_steps=2)
    trainer.train()
    trained = snapshot_training_state(trainer.model, trainer.optimizer,
                                      trainer.lr_scheduler)
    trained = {k: {n: (v.clone() if isinstance(v, torch.Tensor) else v)
                   for n, v in d.items()} if k == "model" else d
               for k, d in trained.items()}
    cb.close()

    cb2 = callback_cls(flash)
    model2 = ToyModel()
    with torch.no_grad():
        model2.net.weight.zero_()  # make divergence obvious
    args2, trainer2 = _toy_trainer(transformers, tmp_path / f"hf2_{tag}",
                                   model2, cb2, max_steps=4)
    trainer2.create_optimizer_and_scheduler(num_training_steps=4)
    state = transformers.TrainerState()
    cb2.on_train_begin(args2, state, None, model=trainer2.model,
                       optimizer=trainer2.optimizer,
                       lr_scheduler=trainer2.lr_scheduler)
    cb2.close()
    resumed = snapshot_training_state(trainer2.model, trainer2.optimizer,
                                      trainer2.lr_scheduler)
    return trained, resumed, state.global_step


def test_hf_trainer_end_to_end_flash_resume(tmp_path):
    """Real transformers Trainer: train, flash-save, then a fresh trainer
    with the callback resumes the weights, moments and schedule from
    shm at the last flash save."""
    transformers = pytest.importorskip("transformers")
    trained, resumed, step = _hf_run_and_resume(
        transformers, tmp_path, FlashCkptCallback, "port")
    assert step == 4  # resumed at the last flash save
    _assert_same_state(trained, resumed)


def test_bfloat16_round_trip(tmp_path):
    """bf16 models (the common HF setup) snapshot and restore exactly."""
    model = torch.nn.Linear(4, 4).to(torch.bfloat16)
    snap = snapshot_training_state(model)
    ckpt = Checkpointer(str(tmp_path / "bf16"), standalone=True)
    ckpt.save_checkpoint(1, snap)
    _, loaded, _ = ckpt.load_checkpoint()
    ckpt.close()
    model2 = torch.nn.Linear(4, 4).to(torch.bfloat16)
    restore_training_state(loaded, model2)
    assert model2.weight.dtype == torch.bfloat16
    assert torch.equal(model.weight.view(torch.int16),
                       model2.weight.view(torch.int16))  # bit-exact


def test_each_packages_callback_restores_the_same_state(tmp_path,
                                                         monkeypatch, job):
    transformers = pytest.importorskip("transformers")
    trained, port_resumed, port_step = _hf_run_and_resume(
        transformers, tmp_path, FlashCkptCallback, "port")
    monkeypatch.setenv("DLROVER_TPU_JOB_NAME", job + "j")
    try:
        jax_trained, jax_resumed, jax_step = _hf_run_and_resume(
            transformers, tmp_path, jax_hf_flash.FlashCkptCallback, "jax")
    finally:
        for seg in os.listdir("/dev/shm"):
            if job + "j" in seg:
                os.unlink(os.path.join("/dev/shm", seg))
    assert port_step == jax_step == 4
    _assert_same_state(trained, jax_trained)
    _assert_same_state(port_resumed, jax_resumed)
    np.testing.assert_array_equal(
        port_resumed["model"]["net.weight"].numpy(),
        trained["model"]["net.weight"].numpy())
