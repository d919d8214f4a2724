"""The check that decides ``correct``, shown to fail: a whole run on the CPU
(the look for a card skipped, tiny widths, fp32) with the timed path broken
underneath comes out not correct, once for each fault a cell can have; and
the control (the reference with float8 operands in the program's place)
reads over the cells' limits."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import harness
from benchmark.reference.unet import Ctx, fp8_round_st
from benchmark.tests.tiny import make_root

RUN = harness.load_module(harness.Path(__file__).resolve().parents[1] / "run.py")


def correct_after(tmp_path, capsys, workload):
    root = make_root(tmp_path)
    wl = harness.load_workload(root, workload)
    assert RUN.execute(wl, 2 ** 33 + 5, 0.5, False, "cpu", 0.0) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _state_unchanged(monkeypatch):
    from diffusioniqt_tpu_torch.diffusion.gaussian import Imagen

    step = Imagen.p_sample

    def unchanged(self, unet, x, t, **kwargs):
        _, x_start = step(self, unet, x, t, **kwargs)
        return x, x_start

    monkeypatch.setattr(Imagen, "p_sample", unchanged)


def _half_batch(monkeypatch):
    from diffusioniqt_tpu_torch.models.unet3d import UNet3D

    forward = UNet3D.forward

    def half(self, x, *args, **kwargs):
        keep = x.shape[0] // 2
        low = kwargs.get("lowres_cond_img")
        if low is not None:
            kwargs["lowres_cond_img"] = low[:keep]
        out = forward(self, x[:keep], args[0], args[1][:keep], **kwargs)
        return torch.cat([out, out])[: x.shape[0]]

    monkeypatch.setattr(UNet3D, "forward", half)


def _answer_altered(monkeypatch):
    from diffusioniqt_tpu_torch.ops.stitch_device import DeviceVolumeStitcher

    add = DeviceVolumeStitcher.add_batch

    def altered(self, outs, starts, valid=None):
        outs = outs.clone()
        outs[0] += 1.0
        return add(self, outs, starts, valid)

    monkeypatch.setattr(DeviceVolumeStitcher, "add_batch", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _answer_altered])
@pytest.mark.parametrize("workload", ["tiny-iqt-serve", "tiny-sr-serve"])
def test_a_served_cell_with_a_fault_is_not_correct(tmp_path, capsys, monkeypatch, workload,
                                                   fault):
    fault(monkeypatch)
    line = correct_after(tmp_path, capsys, workload)
    assert line["correct"] is False, line["checks"]


def _train_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _train_half_rows(monkeypatch):
    """The loss of each microbatch over half of its rows, after a whole
    forward: the outputs are right, the gradient is not."""
    from diffusioniqt_tpu_torch.diffusion import gaussian

    for name, fn in list(gaussian._LOSSES.items()):
        def half(pred, target, fn=fn):
            losses = fn(pred, target)
            keep = losses.shape[0] // 2
            return torch.cat([losses[:keep], losses[:keep]])[: losses.shape[0]]
        monkeypatch.setitem(gaussian._LOSSES, name, half)


def _train_two_microbatches(monkeypatch):
    """The backward of only the first two microbatches of each step."""
    from diffusioniqt_tpu_torch.train.trainer import ImagenTrainer

    loss = ImagenTrainer._loss
    seen = []

    def two(self, index, hr, lr_img, draws):
        out = loss(self, index, hr, lr_img, draws)
        seen.append(1)
        return out if len(seen) % 4 in (1, 2) else out.detach().requires_grad_(True)

    monkeypatch.setattr(ImagenTrainer, "_loss", two)


@pytest.mark.parametrize("fault", [_train_unchanged, _train_half_rows,
                                   _train_two_microbatches])
def test_a_training_cell_with_a_fault_is_not_correct(tmp_path, capsys, monkeypatch, fault):
    fault(monkeypatch)
    line = correct_after(tmp_path, capsys, "tiny-iqt-train")
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("workload", ["tiny-iqt-serve", "tiny-sr-serve", "tiny-iqt-train"])
def test_the_control_reads_over_the_limits(tmp_path, workload):
    root = make_root(tmp_path)
    wl = harness.load_workload(root, workload)
    limits = harness.load_json(root / "benchmark" / "limits" / f"{workload}.json")
    driver = harness.load_module(wl.driver_path())
    ctx = Ctx(q=fp8_round_st)
    if wl.traffic["driver"] == "serve_volumes":
        cell = driver.Serve(wl, 2 ** 35 + 1, "cpu")
        cell.call = 0
        for _ in range(wl.traffic["params"]["recorded_calls"]):
            cell.serve_one()
            cell.call += 1
        cell.free_program()
        control = cell.readings(ctx)
    else:
        cell = driver.Train(wl, 2 ** 35 + 1, "cpu")
        cell.warm()
        cell.free_program()
        control = cell.readings(cell.reference_steps(ctx))
    assert any(v > limits[k] for k, v in control.items() if k in limits), (control, limits)
