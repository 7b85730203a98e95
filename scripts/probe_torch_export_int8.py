#!/usr/bin/env python3
"""Where the int8 export of the serving forward parts from the eager int8
forward on an NVIDIA card. It found the exported upsample in bf16 where
CUDA autocast runs the eager one in f32 (so models/layers.UpsampleBilinear2x
casts it itself); since then it prints every quantize input equal.

1. BatchNorm and the bilinear upsample on [64, 256, 32, 32] inputs, f32 and
   bf16, channels-last and contiguous: eager F.batch_norm / F.interpolate
   against the core-ATen ops an exported program runs
   (_native_batch_norm_legit_no_training, upsample_bilinear2d.vec): equal
   or not, the largest difference, and the device kernels each launches.
2. The flagship (seeded, then 2 and 30 bf16 train steps at B=64) quantized
   on a B=64 synthetic batch: the exported int8 program (tools/export_model,
   saved and run in a child process with TF32 on and off, and in this
   process) against the eager int8 forward: the largest difference, the
   crops that differ and their rotation angles; then the first int8 layer
   whose input differs between the two, and each op from the previous int8
   layer's quantize to that one, in the exported graph and in the eager
   forward (as a TorchDispatchMode sees it), with its dtype, strides and a
   checksum, so that the first op whose output parts shows.

Run on the card:  python3 scripts/probe_torch_export_int8.py   (about 3 minutes)
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from gdrnet_tpu_torch.models import quantize as Q  # noqa: E402
from gdrnet_tpu_torch.tools import export_model as em  # noqa: E402

DEV = "cuda"
CHILD = """
import sys, numpy as np, torch
if sys.argv[3] == "off":
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
fwd = torch.export.load(sys.argv[1]).module()
a = np.load(sys.argv[2])
with torch.no_grad():
    r, t = fwd(*[torch.from_numpy(a[f"arr_{i}"]).cuda() for i in range(8)])
np.savez(sys.argv[1] + sys.argv[3] + ".npz", r=r.float().cpu().numpy(),
         t=t.float().cpu().numpy())
"""


def kernels_of(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, [e.name[:50] for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]


def ops() -> None:
    g = torch.Generator(device=DEV).manual_seed(0)
    for dt in (torch.float32, torch.bfloat16):
        for fmt in ("channels_last", "contiguous"):
            x = torch.randn(64, 256, 32, 32, device=DEV, generator=g).to(dt)
            x = (x.contiguous(memory_format=torch.channels_last) if fmt == "channels_last"
                 else x.contiguous())
            w, b = torch.rand(256, device=DEV) + 0.5, torch.randn(256, device=DEV)
            rm, rv = torch.randn(256, device=DEV) * 0.1, torch.rand(256, device=DEV) + 0.5
            e, ke = kernels_of(lambda: F.batch_norm(x, rm, rv, w, b, False, 0.1, 1e-5))
            a, ka = kernels_of(lambda: torch.ops.aten._native_batch_norm_legit_no_training(
                x, w, b, rm, rv, 0.1, 1e-5)[0])
            print(f"BN {dt} {fmt}: equal={torch.equal(e, a)} "
                  f"max={float((e.float() - a.float()).abs().max()):.3e} eager={ke} aten={ka}",
                  flush=True)
            e, ke = kernels_of(lambda: F.interpolate(x, scale_factor=2, mode="bilinear",
                                                     align_corners=True))
            a, ka = kernels_of(lambda: torch.ops.aten.upsample_bilinear2d.vec(
                x, None, True, [2.0, 2.0]))
            print(f"UP {dt} {fmt}: equal={torch.equal(e, a)} "
                  f"max={float((e.float() - a.float()).abs().max()):.3e} eager={ke} aten={ka}",
                  flush=True)


def _sig(t) -> str:
    if not isinstance(t, torch.Tensor):
        return type(t).__name__
    return (f"{str(t.dtype).replace('torch.', '')} {tuple(t.shape)} {t.stride()} "
            f"sum={float(t.double().sum()):.10e}")


class EagerOps(TorchDispatchMode):
    """The aten ops of an eager forward from its `layer - 1`-th round (a
    quantize) to its `layer`-th, each with its output's signature."""

    def __init__(self, layer: int):
        super().__init__()
        self.layer, self.rounds, self.ops = layer, 0, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func)
        if self.layer - 1 <= self.rounds <= self.layer and (self.ops or "round" in name):
            first = out[0] if isinstance(out, (tuple, list)) and out else out
            self.ops.append((name, _sig(first)))
        self.rounds += "round" in name
        return out


def chain(gm, args, fwd, layer: int) -> None:
    """The ops between int8 layer `layer - 1`'s quantize and `layer`'s, in
    the exported graph and in the eager forward."""
    outs = {}

    class Recorder(torch.fx.Interpreter):
        def run_node(self, n):
            outs[n] = super().run_node(n)
            return outs[n]

    with torch.no_grad():
        Recorder(gm).run(*args)
    nodes = [n for n in gm.graph.nodes if n.op == "call_function"]
    rounds = [i for i, n in enumerate(nodes) if "round" in str(n.target)]
    print(f"  exported graph, quantize #{layer - 1} to #{layer}:", flush=True)
    for n in nodes[rounds[layer - 1]:rounds[layer] + 1]:
        out = outs[n][0] if isinstance(outs[n], (tuple, list)) else outs[n]
        print(f"    {str(n.target):48s} {_sig(out)}", flush=True)
    eager = EagerOps(layer)
    with torch.no_grad(), eager:
        fwd(*args)
    print(f"  eager forward, quantize #{layer - 1} to #{layer}:", flush=True)
    for name, sig in eager.ops:
        print(f"    {name:48s} {sig}", flush=True)


def first_differing_layer(gm, args, recorded: list) -> int | None:
    """Run the exported graph node by node; compare each int8 layer's input
    (the tensor its quantize divides by the scale) with the eager one."""
    outs = {}

    class Recorder(torch.fx.Interpreter):
        def run_node(self, n):
            outs[n] = super().run_node(n)
            return outs[n]

    with torch.no_grad():
        Recorder(gm).run(*args)
    nodes = list(gm.graph.nodes)
    rounds = [i for i, n in enumerate(nodes)
              if n.op == "call_function" and "round" in str(n.target)]
    print(f"  quantize inputs eager {len(recorded)}, round nodes {len(rounds)}", flush=True)
    prev = 0
    for j, (xe, ri) in enumerate(zip(recorded, rounds)):
        xg = outs[nodes[ri].args[0].args[0]]
        if not (xg.shape == xe.shape and torch.equal(xg.float(), xe.float())):
            between = [str(n.target) for n in nodes[prev:ri] if n.op == "call_function"]
            print(f"  first differing quantize input #{j}: max "
                  f"{float((xg.float() - xe.float()).abs().max()):.3e} dtype {xg.dtype} "
                  f"stride {xg.stride()}", flush=True)
            print("  ops since the previous quantize: " + ", ".join(dict.fromkeys(between)),
                  flush=True)
            return j
        prev = ri
    print("  every quantize input equal", flush=True)
    return None


def export_vs_eager() -> None:
    torch.backends.cudnn.allow_tf32 = False  # as the smoke's process runs after [fold_bn]
    torch.backends.cuda.matmul.allow_tf32 = False
    tmp = tempfile.mkdtemp()
    cfg = em.export_config(cs.FLAGSHIP)
    model = cs.init_weights(cs.build_model(cfg, device="cpu"), torch.Generator().manual_seed(0))
    state, step = cs.train_setup(cfg, model.state_dict(), DEV)
    train = cs.to_device(cs.train_batch(cfg, 64, seed=3), DEV)
    batch = em.export_batch(cfg, 64, DEV)
    args = [batch[k] for k in em.ARG_NAMES]
    np.savez(f"{tmp}/args.npz", *[a.cpu().numpy() for a in args])
    done = 0
    for n_steps in (2, 30):
        while done < n_steps:
            step(state, train, None)
            done += 1
        m = state.model.eval()
        fwd = em.ServingForward(Q.quantize_model(m, Q.calibrate_act_scales(m, [batch])))
        recorded, plain = [], Q.quantize_input
        Q.quantize_input = lambda x, s: (recorded.append(x.detach().clone()), plain(x, s))[1]
        try:
            with torch.no_grad():
                want = fwd(*args)
        finally:
            Q.quantize_input = plain
        ep = em.build_exported(fwd, batch)
        path = f"{tmp}/int8_{n_steps}.pt2"
        torch.export.save(ep, path)
        for tf32 in ("on", "off"):
            proc = subprocess.run([sys.executable, "-c", CHILD, path, f"{tmp}/args.npz", tf32],
                                  capture_output=True, text=True)
            if proc.returncode:
                print(proc.stderr[-2000:])
                continue
            o = np.load(path + tf32 + ".npz")
            print(f"steps={n_steps} child TF32 {tf32}: rot "
                  f"{np.abs(o['r'] - want[0].float().cpu().numpy()).max():.3e} trans "
                  f"{np.abs(o['t'] - want[1].float().cpu().numpy()).max():.3e}", flush=True)
        gm = ep.module()
        with torch.no_grad():
            got = gm(*args)
        deg = cs.rot_deg(got[0].float().cpu().numpy(), want[0].float().cpu().numpy())
        differ = np.flatnonzero((got[0] != want[0]).flatten(1).any(1).cpu().numpy()
                                | (got[1] != want[1]).any(1).cpu().numpy())
        print(f"steps={n_steps} exported vs eager: rot {float((got[0] - want[0]).abs().max()):.3e}"
              f" trans {float((got[1] - want[1]).abs().max()):.3e}; crops differing "
              f"{len(differ)} of {len(deg)}, degrees {[round(float(deg[i]), 4) for i in differ]}",
              flush=True)
        layer = first_differing_layer(gm, args, recorded)
        if layer and n_steps == 30:
            chain(gm, args, fwd, layer)


if __name__ == "__main__":
    ops()
    export_vs_eager()
