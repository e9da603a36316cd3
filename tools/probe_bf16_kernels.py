#!/usr/bin/env python3
"""Where the time of the port's bf16 kernels goes, on one CUDA card.

    python3 tools/probe_bf16_kernels.py --parent DIR [--out FILE]
    python3 tools/probe_bf16_kernels.py --parent DIR --k5-only
    python3 tools/probe_bf16_kernels.py --parent DIR --c8-only [--c8-variants no_products=C8_SKIP=1]
    python3 tools/probe_bf16_kernels.py --parent DIR --lvc-only [--lvc-variants no_conv=LVCT_SKIP=1]

DIR is a checkout of an earlier version of the repository (``git archive``
unpacked; ``.`` for this one). The probe builds that version's
``csrc/wavenet_stack_bf16.cu`` (K1-bf16), ``csrc/resblock_bf16.cu``
(K2/K3-bf16) and ``csrc/wavenet_train_bf16.cu`` (K5a/K5b-bf16) beside this
checkout's and measures, at ``chip_smoke.py``'s shapes (K1 at B=1,
T=512/640/2048, L=20, C=H=256; the stage at the five NSF-HiFiGAN stages of
T_mel=512; K5 at B=16, T=1536, L=20, C=256 with H=256, the teacher's, and
H=128, vari's):

- K5a/K5b-bf16 of both versions (``--k5-only``: only these): each checked
  against its plain twin, timed in turns (earlier, this, this, earlier), its
  device time by kernel name (torch.profiler), and beside them the same
  products as bf16 ``torch.matmul`` calls on prebuilt operands, 20 layers
  with no epilogues (a yardstick of the products alone, not one call that
  computes the same function);

- K2 and K2-bf16 at C = 8 (``--c8-only``: only these; B=1, T=131,072,
  V2's last stage), the earlier version's and this one's: each checked
  against its twin, its time split into the launch chain (the same calls at
  T = 64), the device-memory traffic (a build without the products: for the
  earlier per-conv kernels a copy of their source with the FMA loop / the
  mma taken out, for this checkout a ``--c8-variants`` build with
  ``C8_SKIP=1``) and the products (the rest), its device time a call
  (torch.profiler: the mean kernel's times the launches a call makes), and
  both in turns; other ``C8_SKIP`` bits leave out the epilogues (2), the
  global loads (4) and the ResBlocks' copies of x (8);

- K4-bf16 (``--lvc-only``: only these; ``csrc/ublock.cu``'s bf16-window
  build), the earlier version's and this one's, and ``--lvc-variants``
  builds of this checkout's ``ublock.cu``: each block of the LJSpeech
  FastDiff net at T_mel=512 (hops 8 / 64 / 256, its 4 layers, one step of a
  hoisted bf16 stack) checked against its twin, the 4 layers by CUDA graph
  in turns (earlier, this, this, earlier), and each version's device time
  a layer (torch.profiler over eager calls) beside its graph time;

- the earlier version's split: K1's device time by kernel (torch.profiler)
  and its layer chain by phase, from ``%globaltimer`` stamps that a copy of
  its source takes at each block's phase edges (the gate phase, the out
  phase, and the wait at each grid barrier), plus the stack cut to 1, 2, 10
  and 20 layers (CUDA events); the stage's device time by launch (each of
  its convs, torch.profiler) beside each conv's operations and bytes;
- both versions in turns (earlier, this, this, earlier; CUDA events, 3
  warm-ups, mean of 20 calls a turn), each checked against the plain twin.

Prints one JSON line per measurement and writes them all to FILE
(default ``build/probe_bf16_kernels.json``). Needs a CUDA card.
"""

import argparse
import ctypes
import json
import os
import shutil
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

K1_SHAPES = ((1, 512), (1, 640), (1, 2048))
K1_CUTS = (1, 2, 10, 20)
L, C, H = 20, 256, 256
RES_STAGES = ((256, 4096), (128, 32768), (64, 65536), (32, 131072), (16, 262144))
RES_K, RES_D = (3, 7, 11), ((1, 3, 5),) * 3
BF16_PEAK, HBM_RATE = 989e12, 3.35e12
STAMP_MAX_BLOCKS, STAMP_MAX_LAYERS = 2048, 33

# the parent's chain loop, and the same loop with a stamp at each phase edge
CHAIN_LOOP = """  for (int l = p.l0; l < p.l0 + p.G; ++l) {
    for (int i = blockIdx.x; i < n_tiles; i += gridDim.x)
      gate_tile<BM>(p, l, i / n_pt / n_tt, i / n_pt % n_tt * BM, i % n_pt * BP, smem);
    grid.sync();
    for (int i = blockIdx.x; i < n_tiles; i += gridDim.x)
      out_tile<BM>(p, l, i / n_pt / n_tt, i / n_pt % n_tt * BM, i % n_pt * BP, smem);
    if (l + 1 < p.l0 + p.G) grid.sync();
  }
"""
STAMPED_LOOP = """  for (int l = p.l0; l < p.l0 + p.G; ++l) {
    probe_stamp(l - p.l0, 0);
    for (int i = blockIdx.x; i < n_tiles; i += gridDim.x)
      gate_tile<BM>(p, l, i / n_pt / n_tt, i / n_pt % n_tt * BM, i % n_pt * BP, smem);
    probe_stamp(l - p.l0, 1);
    grid.sync();
    probe_stamp(l - p.l0, 2);
    for (int i = blockIdx.x; i < n_tiles; i += gridDim.x)
      out_tile<BM>(p, l, i / n_pt / n_tt, i / n_pt % n_tt * BM, i % n_pt * BP, smem);
    probe_stamp(l - p.l0, 3);
    if (l + 1 < p.l0 + p.G) grid.sync();
  }
  probe_stamp(p.G, 0);
"""
STAMP_DEFS = f"""
#include <cstdint>
__device__ unsigned long long probe_stamps[{STAMP_MAX_BLOCKS} * {STAMP_MAX_LAYERS} * 4];
__device__ __forceinline__ void probe_stamp(int layer, int edge) {{
  __syncthreads();
  if (threadIdx.x == 0 && blockIdx.x < {STAMP_MAX_BLOCKS} && layer < {STAMP_MAX_LAYERS}) {{
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    probe_stamps[(blockIdx.x * {STAMP_MAX_LAYERS} + layer) * 4 + edge] = t;
  }}
}}
extern "C" int probe_read_stamps(unsigned long long* host, int n) {{
  return (int)cudaMemcpyFromSymbol(host, probe_stamps, n * sizeof(unsigned long long));
}}
"""

records = []


def emit(kind, **kw):
    rec = dict(probe=kind, **kw)
    records.append(rec)
    print(json.dumps(rec), flush=True)


def build_variant(name, src_dir, tag):
    """Build ``src_dir/{name}.cu`` (with the headers beside it) as a library
    of its own, through the package's builder."""
    from prodiff_tpu_torch.ops import cuda_build

    saved = cuda_build.CSRC_DIR
    cuda_build.CSRC_DIR = src_dir
    try:
        return cuda_build.load(name, (f"PROBE_VARIANT_{tag}=1",))
    finally:
        cuda_build.CSRC_DIR = saved


def parent_sources(parent, stamped):
    """A copy of the parent's csrc under build/; with ``stamped``, its K1
    chain takes the stamps."""
    src = os.path.join(parent, "prodiff_tpu_torch", "csrc")
    dst = os.path.join(ROOT, "build", "probe_stamped" if stamped else "probe_parent")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    if not stamped:
        return dst
    path = os.path.join(dst, "wavenet_stack_bf16.cu")
    with open(path) as f:
        text = f.read()
    if CHAIN_LOOP not in text:
        raise SystemExit("probe: the parent's chain loop is not the one this probe stamps")
    text = text.replace(CHAIN_LOOP, STAMPED_LOOP)
    head = text.index("namespace {")
    text = text[:head] + STAMP_DEFS + "\n" + text[head:]
    with open(path, "w") as f:
        f.write(text)
    return dst


def rand(rng, dev, torch, *shape, scale=1.0):
    return torch.tensor(rng.normal(size=shape) * scale, dtype=torch.float32, device=dev)


def k1_weights(rng, dev, torch, n_layers):
    from prodiff_tpu_torch.ops import wavenet_stack as wn

    w = wn.StackedWaveNet(
        dilated_w=rand(rng, dev, torch, n_layers, 3, C, 2 * C, scale=(3 * C) ** -0.5),
        dilated_b=rand(rng, dev, torch, n_layers, 2 * C, scale=0.1),
        diff_w=rand(rng, dev, torch, n_layers, C, C, scale=C ** -0.5),
        diff_b=rand(rng, dev, torch, n_layers, C, scale=0.1),
        cond_w=rand(rng, dev, torch, n_layers, H, 2 * C, scale=H ** -0.5),
        cond_b=rand(rng, dev, torch, n_layers, 2 * C, scale=0.1),
        out_w=rand(rng, dev, torch, n_layers, C, 2 * C, scale=C ** -0.5),
        out_b=rand(rng, dev, torch, n_layers, 2 * C, scale=0.1))
    return wn.cast_stack(w, torch.bfloat16)


class ParentK1:
    """The parent's K1-bf16 wrapper (ops/wavenet_stack.py at the parent),
    calling its library."""

    ROWS = {32: 1.0, 16: 1.2}

    def __init__(self, lib, torch):
        self.lib, self.torch = lib, torch
        lib.wavenet_residual_stack_bf16.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        lib.wavenet_residual_stack_bf16.restype = ctypes.c_int
        lib.wavenet_chain_slots_bf16.argtypes = [ctypes.c_int]
        lib.wavenet_chain_slots_bf16.restype = ctypes.c_int
        self.slots = None
        self.grid = None

    def __call__(self, x0, cond, step, w):
        torch = self.torch
        b, t, c = x0.shape
        n_layers, h, _ = w.cond_w.shape
        if self.slots is None:
            self.slots = {r: self.lib.wavenet_chain_slots_bf16(r) for r in self.ROWS}

        def cost(rows):
            tiles = b * -(-t // rows) * (c // 32)
            return -(-tiles // max(1, self.slots[rows])) * rows * self.ROWS[rows]

        rows = min(self.ROWS, key=cost)
        group = max(1, min(n_layers, (1 << 30) // (4 * b * t * 2 * c)))
        self.grid = (min(b * -(-t // rows) * (c // 32), self.slots[rows]), rows, group)
        x = x0.clone()
        skip = torch.empty_like(x)
        gate = torch.empty_like(x, dtype=torch.bfloat16)
        sp = torch.empty((n_layers, b, c), device=x.device)
        zc = torch.empty((group, b, t, 2 * c), device=x.device)
        err = self.lib.wavenet_residual_stack_bf16(
            x.data_ptr(), skip.data_ptr(), gate.data_ptr(), sp.data_ptr(), zc.data_ptr(),
            cond.data_ptr(), step.data_ptr(), *(a.data_ptr() for a in w),
            b, t, c, h, n_layers, group, rows, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent K1-bf16: CUDA error {err}")
        return skip


class ParentStage:
    """A resblock stage entry of another build (the parent's, or a variant of
    this checkout's), called as ops/resblock.py calls it: ``fn`` is
    ``resblock_stage_bf16`` (bf16 taps) or ``resblock_stage`` (float32)."""

    def __init__(self, lib, torch, fn="resblock_stage_bf16"):
        self.fn, self.torch = getattr(lib, fn), torch
        self.fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.POINTER(ctypes.c_int)] * 3 + [
            ctypes.c_int] * 4 + [ctypes.c_void_p]
        self.fn.restype = ctypes.c_int

    def __call__(self, x, w, biases, ksizes, dsizes):
        torch = self.torch
        b, t, c = x.shape
        out, h, tmp = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)

        def arr(v):
            return (ctypes.c_int * len(v))(*v)

        err = self.fn(x.data_ptr(), out.data_ptr(), h.data_ptr(), tmp.data_ptr(), w.data_ptr(),
                      biases.data_ptr(), arr(list(ksizes)), arr([len(d) for d in dsizes]),
                      arr([d for ds in dsizes for d in ds]), len(ksizes), b, t, c,
                      torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"resblock stage ({self.fn.__name__}): CUDA error {err}")
        return out


class LvcBuild:
    """K4's (``layer``) and K7's (``block``) C entries of another build (the
    parent's, or a variant of this checkout's), called as ops/ublock.py's
    ``ublock_layer`` and ``ublock_block`` call them, with their arguments;
    the window kernels' dtype picks the entry. Launches are not counted."""

    def __init__(self, torch, layer_lib=None, block_lib=None):
        from prodiff_tpu_torch.ops import ublock as ub

        self.torch, self.layer_lib, self.block_lib = torch, layer_lib, block_lib
        for dtype in (torch.float32, torch.bfloat16):
            if layer_lib is not None:
                ub.bind_layer_library(layer_lib, dtype)
            if block_lib is not None:
                ub.bind_block_library(block_lib, dtype)

    def _entry(self, lib, name, kmat):
        return getattr(lib, name + ("_bf16" if kmat.dtype == self.torch.bfloat16 else ""))

    def layer(self, x, ad, cw, cb, kmat, bias, dilation, hop, step_idx, layer_idx):
        torch = self.torch
        b, t, c = x.shape
        out = torch.empty_like(x)
        err = self._entry(self.layer_lib, "ublock_layer_forward", kmat)(
            x.data_ptr(), ad.data_ptr(), cw.data_ptr(), cb.data_ptr(), kmat.data_ptr(),
            bias.data_ptr(), out.data_ptr(), b, t, kmat.shape[-3], hop, dilation,
            bias.shape[-1] // (2 * c), step_idx, layer_idx, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"ublock_layer_forward ({self.layer_lib}): CUDA error {err}")
        return out

    def block(self, x, ad, cws, cbs, kmat, bias, dilations, hop, step_idx):
        from prodiff_tpu_torch.ops.ublock import pingpong

        torch = self.torch
        b, t, c = x.shape
        n = len(dilations)
        cw, cb = torch.stack(list(cws)), torch.stack(list(cbs))
        bufs = {"x": x, "out": torch.empty_like(x), "scratch": torch.empty_like(x)}
        plan = pingpong(n)
        err = self._entry(self.block_lib, "ublock_block_forward", kmat)(
            (ctypes.c_void_p * n)(*(bufs[s].data_ptr() for s, _ in plan)),
            (ctypes.c_void_p * n)(*(bufs[d].data_ptr() for _, d in plan)), ad.data_ptr(),
            cw.data_ptr(), cb.data_ptr(), kmat.data_ptr(), bias.data_ptr(),
            (ctypes.c_int * n)(*dilations), n, b, t, kmat.shape[-3], hop,
            bias.shape[-1] // (2 * c), step_idx, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"ublock_block_forward ({self.block_lib}): CUDA error {err}")
        return bufs["out"]


LVC_HOPS, LVC_WINDOWS, LVC_LAYERS = (8, 64, 256), 512, 4  # the LJSpeech FastDiff net


def graph_replay(fn, torch):
    """``fn`` captured into a CUDA graph (after a warm call): its replay."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def lvc_probe(builds, torch, dev):
    """K4-bf16 by each build of ``builds`` (name -> a layer call with
    ``ublock_layer``'s arguments; "earlier" and "this" timed in turns) at
    the LJSpeech blocks: checked against the twin, the block's 4 layers
    (dilations 1, 3, 9, 27; step 0 of a 4-step bf16 stack) by CUDA graph,
    and each build's device time a layer (torch.profiler, 10 eager passes)."""
    from prodiff_tpu_torch.ops.ublock import ublock_layer_plain

    rng = np.random.default_rng(23)
    c = 32
    for hop in LVC_HOPS:
        t = LVC_WINDOWS * hop
        x, ad = rand(rng, dev, torch, 1, t, c), rand(rng, dev, torch, 1, t, c)
        cws = [rand(rng, dev, torch, c, c, 3, scale=0.2) for _ in range(LVC_LAYERS)]
        cbs = [rand(rng, dev, torch, c, scale=0.1) for _ in range(LVC_LAYERS)]
        km = rand(rng, dev, torch, 4, 1, LVC_WINDOWS, LVC_LAYERS * 3 * c, 2 * c,
                  scale=0.1).to(torch.bfloat16)
        lb = rand(rng, dev, torch, 4, 1, LVC_WINDOWS, LVC_LAYERS * 2 * c, scale=0.1)

        def chain(layer):
            def run():
                h = x
                for i in range(LVC_LAYERS):
                    h = layer(h, ad, cws[i], cbs[i], km, lb, 3 ** i, hop, 0, i)
                return h
            return run
        want = chain(ublock_layer_plain)()
        runs = {name: chain(layer) for name, layer in builds.items()}
        rec = {"hop": hop, "T": t}
        for name, run in runs.items():
            kern = [us for n, us in device_kernels(run, 10, torch) if "ublock" in n]
            rec[name] = {"max_abs_err": float((run() - want).abs().max()),
                         "graph_ms": timed_ms(graph_replay(run, torch), 20, torch) / LVC_LAYERS,
                         "device_ms": sum(kern) / len(kern) / 1e3, "kernels": len(kern)}
        earlier, this = graph_replay(runs["earlier"], torch), graph_replay(runs["this"], torch)
        rec["in_turns_ms"] = {"earlier": [], "this": []}
        for name, fn in (("earlier", earlier), ("this", this), ("this", this),
                         ("earlier", earlier)):
            rec["in_turns_ms"][name].append(timed_ms(fn, 20, torch) / LVC_LAYERS)
        emit("lvc_bf16_layer", **rec)
        del km, lb
        torch.cuda.empty_cache()


K5_SHAPES = ((16, 1536, 256, 256), (16, 1536, 256, 128))  # the teacher's and vari's
K5_NAMES = ("step_proj", "save_gate", "save_out", "save_prep", "save_layer", "chain_gate",
            "chain_dy", "chain_prep", "chain_layer")


class ParentK5:
    """The parent's K5a/K5b-bf16 wrappers (ops/wavenet_train.py of the earlier design:
    1 + 2L and 2L launches, a bf16 gate scratch), calling its library."""

    def __init__(self, lib, torch):
        self.lib, self.torch = lib, torch
        lib.wavenet_stack_save_forward_bf16.argtypes = [ctypes.c_void_p] * 16 + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.wavenet_stack_save_forward_bf16.restype = ctypes.c_int
        lib.wavenet_stack_backward_chain_bf16.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.wavenet_stack_backward_chain_bf16.restype = ctypes.c_int

    def save(self, x0, cond, step, w):
        torch = self.torch
        b, t, c = x0.shape
        n_layers, h, _ = w.cond_w.shape
        x = x0.clone()
        skip, gate = torch.empty_like(x), torch.empty_like(x, dtype=torch.bfloat16)
        sp = torch.empty((n_layers, b, c), device=x.device)
        xs = torch.empty((n_layers, b, t, c), device=x.device, dtype=torch.bfloat16)
        zs = torch.empty((n_layers, b, t, 2 * c), device=x.device, dtype=torch.bfloat16)
        err = self.lib.wavenet_stack_save_forward_bf16(
            x.data_ptr(), skip.data_ptr(), gate.data_ptr(), sp.data_ptr(), xs.data_ptr(),
            zs.data_ptr(), cond.data_ptr(), step.data_ptr(), *(a.data_ptr() for a in w),
            b, t, c, h, n_layers, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent K5a-bf16: CUDA error {err}")
        return skip, xs, zs

    def chain(self, zs, g, w):
        torch = self.torch
        n_layers, b, t, c2 = zs.shape
        c = c2 // 2
        dwt = w.dilated_w.transpose(2, 3).contiguous()
        owt = w.out_w.transpose(1, 2).contiguous()
        dx = torch.zeros_like(g)
        dz = torch.empty((b, t, n_layers, c2), device=g.device, dtype=torch.bfloat16)
        dy = torch.empty((n_layers, b, t, c), device=g.device, dtype=torch.bfloat16)
        err = self.lib.wavenet_stack_backward_chain_bf16(
            zs.data_ptr(), g.data_ptr(), dwt.data_ptr(), owt.data_ptr(), dx.data_ptr(),
            dz.data_ptr(), dy.data_ptr(), b, t, c, n_layers, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent K5b-bf16: CUDA error {err}")
        return dz.permute(2, 0, 1, 3), dy, dx


def k5_by_kernel(fn, torch, n=3):
    """Device ms a call of ``fn`` by kernel (K5_NAMES), and the launches a
    call (torch.profiler over ``n`` calls)."""
    kern = device_kernels(fn, n, torch)
    by = {}
    for name, us in kern:
        key = next((k for k in K5_NAMES if k + "_kernel" in name), name[:60])
        by[key] = by.get(key, 0.0) + us / n / 1e3
    return {k: round(v, 5) for k, v in by.items()}, len(kern) / n


def k5_products_ms(b, t, c, h, n_layers, torch, dev):
    """The save-forward's and the chain's products alone, as bf16
    torch.matmul calls on prebuilt operands over ``n_layers`` layers (the
    conv and cond product as one [BT, 3C + H] x [3C + H, 2C], the out product
    [BT, C] x [C, 2C]; the chain's [BT, 2C] x [2C, C] and [BT, 6C] x [6C,
    C]): a yardstick of what the tensor cores take through cuBLAS for the
    same operations, with no epilogue and no halo. Not one call that
    computes the same function."""
    bt = b * t
    gen = torch.Generator(device=dev).manual_seed(5)

    def r(*shape):
        return torch.randn(*shape, device=dev, dtype=torch.bfloat16, generator=gen)

    a_in, a_gate = r(bt, 3 * c + h), r(bt, c)
    w_in, w_out = r(n_layers, 3 * c + h, 2 * c), r(n_layers, c, 2 * c)
    a_do, a_dz = r(bt, 2 * c), r(bt, 6 * c)
    w_do, w_dz = r(n_layers, 2 * c, c), r(n_layers, 6 * c, c)

    def save():
        for l in range(n_layers):
            torch.matmul(a_in, w_in[l])
            torch.matmul(a_gate, w_out[l])

    def chain():
        for l in range(n_layers):
            torch.matmul(a_do, w_do[l])
            torch.matmul(a_dz, w_dz[l])

    return timed_ms(save, 10, torch), timed_ms(chain, 10, torch)


def variant_k5(lib):
    """This checkout's K5a/K5b-bf16 wrappers calling a variant build of its
    source: (save, chain)."""
    from prodiff_tpu_torch.ops import wavenet_train as wt

    lib.wavenet_stack_save_forward_bf16.argtypes = wt._SAVE_ARGTYPES_BF16
    lib.wavenet_stack_save_forward_bf16.restype = ctypes.c_int
    lib.wavenet_stack_backward_chain_bf16.argtypes = wt._CHAIN_ARGTYPES_BF16
    lib.wavenet_stack_backward_chain_bf16.restype = ctypes.c_int

    def through(fn):
        def run(*args):
            saved = wt._library
            wt._library = lambda dtype=None: lib
            try:
                return fn(*args)
            finally:
                wt._library = saved
        return run

    return through(wt.residual_stack_save), through(wt.residual_stack_chain)


def k5_probe(parent, torch, dev, shapes=K5_SHAPES, emit_fn=None, variants=None):
    """Both versions of K5a/K5b-bf16 at ``shapes``: errors against the twins,
    times in turns, device time by kernel, the products' yardstick; and
    ``variants`` (name: (save, chain) of variant builds) timed in the same
    turns. Returns one record a shape."""
    from prodiff_tpu_torch.ops import wavenet_stack as wn
    from prodiff_tpu_torch.ops import wavenet_train as wt

    emit_fn = emit_fn or emit
    out = []
    for b, t, c, h in shapes:
        rng = np.random.default_rng(41)
        w32 = wn.StackedWaveNet(
            dilated_w=rand(rng, dev, torch, L, 3, c, 2 * c, scale=(3 * c) ** -0.5),
            dilated_b=rand(rng, dev, torch, L, 2 * c, scale=0.1),
            diff_w=rand(rng, dev, torch, L, c, c, scale=c ** -0.5),
            diff_b=rand(rng, dev, torch, L, c, scale=0.1),
            cond_w=rand(rng, dev, torch, L, h, 2 * c, scale=h ** -0.5),
            cond_b=rand(rng, dev, torch, L, 2 * c, scale=0.1),
            out_w=rand(rng, dev, torch, L, c, 2 * c, scale=c ** -0.5),
            out_b=rand(rng, dev, torch, L, 2 * c, scale=0.1))
        w = wn.cast_stack(w32, torch.bfloat16)
        del w32
        x0, cond, step, g = (rand(rng, dev, torch, b, t, c), rand(rng, dev, torch, b, t, h),
                             rand(rng, dev, torch, b, c), rand(rng, dev, torch, b, t, c))
        want = wt.residual_stack_save_plain(x0, cond, step, w)
        variants = variants or {}
        saves = {"parent": parent.save, "this": wt.residual_stack_save,
                 **{k: v[0] for k, v in variants.items()}}
        chains = {"parent": parent.chain, "this": wt.residual_stack_chain,
                  **{k: v[1] for k, v in variants.items()}}
        errs = {}
        for name, fn in saves.items():
            got = fn(x0, cond, step, w)
            errs[f"save_{name}"] = max(peak_err(a, b_) for a, b_ in zip(got, want))
            del got
        zs = want[2]
        del want
        want = wt.residual_stack_chain_plain(zs, g, w)
        for name, fn in chains.items():
            got = fn(zs, g, w)
            errs[f"chain_{name}"] = max(peak_err(a, b_) for a, b_ in zip(got, want))
            del got
        del want
        fns = {"save": {k: (lambda f=f: f(x0, cond, step, w)) for k, f in saves.items()},
               "chain": {k: (lambda f=f: f(zs, g, w)) for k, f in chains.items()}}
        times, split, launches = {}, {}, {}
        for kind, pair in fns.items():
            times[kind] = {k: [] for k in pair}
            for who in ("parent", "this", *variants, "this", "parent"):
                times[kind][who].append(round(timed_ms(pair[who], 10, torch), 5))
            for who in ("parent", "this"):
                split[f"{kind}_{who}"], launches[f"{kind}_{who}"] = k5_by_kernel(pair[who], torch)
        save_mm, chain_mm = k5_products_ms(b, t, c, h, L, torch, dev)
        rec = dict(b=b, t=t, c=c, h=h, n_layers=L, err_of_peak=errs, ms=times,
                   device_ms_by_kernel=split, launches=launches,
                   products_only_ms={"save": round(save_mm, 5), "chain": round(chain_mm, 5),
                                     "note": "bf16 torch.matmul of the same products on "
                                             "prebuilt operands, no epilogues: not one call "
                                             "for the same function"})
        emit_fn("k5_in_turns", **rec)
        out.append(rec)
        del x0, cond, step, g, zs, w
        torch.cuda.empty_cache()
    return out


def timed_ms(fn, reps, torch):
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_kernels(fn, n, torch):
    """(name, microseconds) of every device kernel of ``n`` calls of ``fn``,
    in launch order (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type.name == "CUDA" and "emcpy" not in e.name
           and "emset" not in e.name]
    evs.sort(key=lambda e: e.time_range.start)
    return [(e.name, e.time_range.end - e.time_range.start) for e in evs]


def peak_err(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def k1_split(parent, torch, dev):
    from prodiff_tpu_torch.ops import wavenet_stack as wn

    rng = np.random.default_rng(17)
    w = k1_weights(rng, dev, torch, L)
    n_stamps = STAMP_MAX_BLOCKS * STAMP_MAX_LAYERS * 4
    for b, t in K1_SHAPES:
        x0, cond, step = (rand(rng, dev, torch, b, t, C), rand(rng, dev, torch, b, t, H),
                          rand(rng, dev, torch, b, C))
        want = wn.residual_stack_plain(x0, cond, step, w)
        got = parent(x0, cond, step, w)
        err = peak_err(got, want)
        kern = device_kernels(lambda: parent(x0, cond, step, w), 10, torch)
        by = {}
        for name, us in kern:
            key = next((k for k in ("step_proj", "cond_kernel", "chain_kernel") if k in name), name)
            by[key] = by.get(key, 0.0) + us / 10 / 1e3
        cuts = {}
        for n_cut in K1_CUTS:
            wc = wn.StackedWaveNet(*(a[:n_cut] for a in w))
            cuts[n_cut] = timed_ms(lambda: parent(x0, cond, step, wc), 20, torch)
        # the stamped chain: one call after a warm-up
        parent(x0, cond, step, w)
        torch.cuda.synchronize()
        host = (ctypes.c_ulonglong * n_stamps)()
        if parent.lib.probe_read_stamps(host, n_stamps):
            raise RuntimeError("probe_read_stamps failed")
        grid, rows, group = parent.grid
        s = np.frombuffer(host, dtype=np.uint64).reshape(STAMP_MAX_BLOCKS, STAMP_MAX_LAYERS, 4)
        s = s[:grid].astype(np.float64)
        g = min(group, L)
        gate = s[:, :g, 1] - s[:, :g, 0]
        wait1 = s[:, :g, 2] - s[:, :g, 1]
        out = s[:, :g, 3] - s[:, :g, 2]
        nxt = np.concatenate([s[:, 1:g, 0], s[:, g:g + 1, 0]], axis=1)
        wait2 = nxt - s[:, :g, 3]
        span = s[:, g, 0].max() - s[:, 0, 0].min()
        last1 = np.argmax(s[:, :g, 1], axis=0)  # the last block into each first barrier
        bar1 = wait1[last1, np.arange(g)]
        last2 = np.argmax(s[:, :g, 3], axis=0)
        bar2 = wait2[last2, np.arange(g)]
        us = 1e-3  # globaltimer is in ns
        emit("k1_split", b=b, t=t, grid=grid, rows=rows, err_of_peak=err,
             kernel_ms=by_ms(by), chain_span_ms=span * us / 1e3,
             per_layer_us=dict(gate_mean=float(gate.mean() * us), gate_max=float(gate.max(0).mean() * us),
                               out_mean=float(out.mean() * us), out_max=float(out.max(0).mean() * us),
                               wait_after_gate_mean=float(wait1.mean() * us),
                               wait_after_out_mean=float(wait2[:, :-1].mean() * us) if g > 1 else 0.0,
                               barrier_after_gate=float(bar1.mean() * us),
                               barrier_after_out=float(bar2[:-1].mean() * us) if g > 1 else 0.0),
             layers_ms={str(k): v for k, v in cuts.items()})


def by_ms(by):
    return {k: round(v, 5) for k, v in by.items()}


def stage_split(parent, torch, dev):
    from prodiff_tpu_torch.ops.resblock import resblock_stage_plain

    rng = np.random.default_rng(19)
    convs = [(k, d) for k, ds in zip(RES_K, RES_D) for d in ds for d in (d, 1)]
    for c, t in RES_STAGES:
        w = torch.cat([rand(rng, dev, torch, k * c * c, scale=(k * c) ** -0.5)
                       for k in RES_K for _ in range(6)]).to(torch.bfloat16)
        biases, x = rand(rng, dev, torch, 18, c, scale=0.1), rand(rng, dev, torch, 1, t, c)
        err = peak_err(parent(x, w, biases, RES_K, RES_D), resblock_stage_plain(x, w, biases, RES_K, RES_D))
        kern = [us for name, us in device_kernels(lambda: parent(x, w, biases, RES_K, RES_D), 5, torch)
                if "conv_kernel" in name]
        if len(kern) != 5 * 18:
            emit("stage_split", c=c, t=t, note=f"profiler saw {len(kern)} conv launches, not 90")
            continue
        per = np.array(kern).reshape(5, 18).mean(0) / 1e3
        rows = []
        for i, ((k, d), ms) in enumerate(zip(convs, per)):
            flops = 2 * t * c * c * k
            first = i % 2 == 0
            # conv1: read x/h, write tmp; conv2: read tmp and the residual, write h/out
            nbytes = 2 * k * c * c + 4 * t * c * (2 if first else 3)
            rows.append(dict(conv=i, k=k, d=d, ms=round(float(ms), 5),
                             ops_ms=round(flops / BF16_PEAK * 1e3, 5),
                             bytes_ms=round(nbytes / HBM_RATE * 1e3, 5)))
        emit("stage_split", c=c, t=t, err_of_peak=err, total_ms=round(float(per.sum()), 5), convs=rows)


# A copy of the earlier per-conv C = 8 kernels without their products: the
# float32 conv's FMA loop (run_chunks' mac) and the bf16 conv's mma (its
# ldmatrix kept), as (source, the text replaced, its replacement).
C8_NO_PRODUCTS = (
    ("resblock", "  tile::run_chunks(C / BK, fetch, put, mac);",
     "  tile::run_chunks(C / BK, fetch, put, [](int, int) {});"),
    ("resblock_bf16", "      mma::mma16816(acc[mi], a, bfr[p][0], bfr[p][1]);", "      (void)a;"),
)
C8_T, C8_TINY_T = 131072, 64  # V2's last stage at T_mel = 512; one block a launch
C8_ENTRIES = {"float32": ("resblock", "resblock_stage"),
              "bf16": ("resblock_bf16", "resblock_stage_bf16")}


def c8_sources(parent):
    """The earlier csrc with its C = 8 products taken out (build/probe_c8)."""
    src = os.path.join(parent, "prodiff_tpu_torch", "csrc")
    dst = os.path.join(ROOT, "build", "probe_c8")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    for name, old, new in C8_NO_PRODUCTS:
        path = os.path.join(dst, f"{name}.cu")
        with open(path) as f:
            text = f.read()
        if old not in text:
            return None  # not the per-conv design this copy edits
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return dst


def c8_probe(parent, torch, dev, this_variants=None, emit_fn=None):
    """K2 and K2-bf16 at C = 8 (B=1, T=131,072, V2's (3, 7, 11) x (1, 3, 5)):
    for the earlier build and this checkout's, each checked against the
    twin; the time split into the launch chain (the same calls at T = 64,
    one block a launch), the device-memory traffic (a build without the
    products) and the products (the rest); the device time by kernel
    (torch.profiler); then both in turns (earlier, this, this, earlier).
    ``this_variants``: {dtype: {name: stage}}, builds of this checkout's
    sources without a part (``C8_SKIP``)."""
    from prodiff_tpu_torch.ops.resblock import resblock_stage, resblock_stage_plain

    emit_fn = emit_fn or emit
    plain = parent_sources(parent, False)
    bare = c8_sources(parent)
    rng = np.random.default_rng(29)
    w32 = torch.cat([rand(rng, dev, torch, k * 64, scale=(k * 8) ** -0.5)
                     for k in RES_K for _ in range(6)])
    biases = rand(rng, dev, torch, 18, 8, scale=0.1)
    x, tiny = rand(rng, dev, torch, 1, C8_T, 8), rand(rng, dev, torch, 1, C8_TINY_T, 8)
    out = {}
    for dt, (name, fn) in C8_ENTRIES.items():
        w = w32 if dt == "float32" else w32.to(torch.bfloat16)
        earlier = ParentStage(build_variant(name, plain, "PARENT"), torch, fn)
        stages = {"earlier": earlier,
                  "this": lambda *a: resblock_stage(*a)}
        if bare is not None:
            stages["earlier_no_products"] = ParentStage(build_variant(name, bare, "C8_BARE"),
                                                        torch, fn)
        stages.update((this_variants or {}).get(dt, {}))
        want = resblock_stage_plain(x, w, biases, RES_K, RES_D)
        rec = {"dtype": dt, "ms": {}, "tiny_ms": {}, "device_ms": {}, "launches": {},
               "err_of_peak": {}}
        for key, st in stages.items():
            rec["err_of_peak"][key] = peak_err(st(x, w, biases, RES_K, RES_D), want)
            rec["ms"][key] = timed_ms(lambda: st(x, w, biases, RES_K, RES_D), 20, torch)
            rec["tiny_ms"][key] = timed_ms(lambda: st(tiny, w, biases, RES_K, RES_D), 20, torch)
            # the profiler may miss the first few kernels of its window: a
            # call's device time is the mean kernel's times the launches a
            # call makes (18 for the per-conv design, 1 for the stage kernel)
            kern = device_kernels(lambda: st(x, w, biases, RES_K, RES_D), 5, torch)
            per_call = 18 if key.startswith("earlier") else 1
            rec["launches"][key] = len(kern) / 5
            rec["device_ms"][key] = sum(us for _, us in kern) / len(kern) * per_call / 1e3
        for who in ("earlier", "this"):
            ms, tiny_ms = rec["ms"][who], rec["tiny_ms"][who]
            if f"{who}_no_products" in rec["ms"]:
                bare_ms = rec["ms"][f"{who}_no_products"]
                rec[f"{who}_split_ms"] = {"launch_chain": tiny_ms,
                                          "memory_round_trips": bare_ms - tiny_ms,
                                          "products": ms - bare_ms,
                                          "launch_gaps": ms - rec["device_ms"][who]}
        turns = {"earlier": [], "this": []}
        for who in ("earlier", "this", "this", "earlier"):
            turns[who].append(timed_ms(lambda: stages[who](x, w, biases, RES_K, RES_D), 20, torch))
        rec["in_turns_ms"] = turns
        emit_fn("c8_probe", **rec)
        out[dt] = rec
    return out


def variant_k1(lib, torch):
    """This checkout's K1-bf16 wrapper calling a variant build of its source."""
    from prodiff_tpu_torch.ops import wavenet_stack as wn

    lib.wavenet_residual_stack_bf16.argtypes = wn._ARGTYPES_BF16
    lib.wavenet_residual_stack_bf16.restype = ctypes.c_int
    lib.wavenet_cluster_slots_bf16.argtypes = [ctypes.c_int] * 2
    lib.wavenet_cluster_slots_bf16.restype = ctypes.c_int

    def call(x0, cond, step, w):
        saved = wn._library
        wn._library = lambda dtype=None: lib
        try:
            return wn.residual_stack(x0, cond, step, w)
        finally:
            wn._library = saved

    return call


def stamp_split(stamps):
    """A layer's phases (us, the mean over the stamped blocks and layers: a
    layer group's later layers, never stamped, stay 0 and are left out) from
    the K1_STAMPS build's [block][layer][edge] stamps; ``layer`` the period
    between consecutive stamped layers' starts."""
    st = stamps.astype(np.float64)
    valid = (st > 0).all(axis=2)
    d = np.diff(st, axis=2)[valid] / 1e3
    names = ("gate_product", "gate_epilogue", "gate_exchange", "out_product", "out_epilogue_y")
    split = {k: float(d[:, i].mean()) for i, k in enumerate(names)}
    both = valid[:, 1:] & valid[:, :-1]
    split["layer"] = float((st[:, 1:, 0] - st[:, :-1, 0])[both].mean() / 1e3)
    split["blocks"] = int(valid.any(axis=1).sum())
    return split


def k1_phases(lib, torch, dev):
    """This checkout's K1-bf16 (a K1_STAMPS build) at chip_smoke.py's shapes:
    each layer's phases from the blocks' %globaltimer stamps, microseconds,
    the mean over the stamped blocks and layers."""
    from prodiff_tpu_torch.ops import wavenet_stack as wn

    call = variant_k1(lib, torch)
    rng = np.random.default_rng(29)
    w = k1_weights(rng, dev, torch, L)
    blocks, layers, edges = 64, 64, 6
    for b, t in K1_SHAPES:
        x0, cond, step = (rand(rng, dev, torch, b, t, C), rand(rng, dev, torch, b, t, H),
                          rand(rng, dev, torch, b, C))
        call(x0, cond, step, w)
        torch.cuda.synchronize()
        if lib.wavenet_clear_stamps_bf16():
            raise RuntimeError("wavenet_clear_stamps_bf16 failed")
        call(x0, cond, step, w)
        torch.cuda.synchronize()
        host = (ctypes.c_ulonglong * (blocks * layers * edges))()
        if lib.wavenet_read_stamps_bf16(host, blocks * layers * edges):
            raise RuntimeError("wavenet_read_stamps_bf16 failed")
        split = stamp_split(np.frombuffer(host, dtype=np.uint64).reshape(blocks, layers, edges))
        emit("k1_phases", b=b, t=t, per_layer_us={k: round(v, 3) for k, v in split.items()})


def k1_schedules(torch, dev, schedules):
    """This checkout's K1-bf16 at chip_smoke.py's shapes under each forced
    (layers a group, warpgroups a block) schedule: mean of 20 calls and the
    error against the plain twin, beside the wrapper's own choice."""
    from prodiff_tpu_torch.ops import wavenet_stack as wn

    lib = wn._library(torch.bfloat16)
    rng = np.random.default_rng(31)
    w = k1_weights(rng, dev, torch, L)
    for b, t in K1_SHAPES:
        x0, cond, step = (rand(rng, dev, torch, b, t, C), rand(rng, dev, torch, b, t, H),
                          rand(rng, dev, torch, b, C))
        want = wn.residual_stack_plain(x0, cond, step, w)
        row = {}
        for group, nwg in schedules:
            if 64 * nwg - 2 * group < 1:
                continue
            skip = torch.empty_like(x0)
            xa, xb = torch.empty_like(x0), torch.empty_like(x0)
            sp = torch.empty((L, b, C), device=dev)
            zc = torch.empty((group, b, t, 2 * C), device=dev)

            def call():
                err = lib.wavenet_residual_stack_bf16(
                    x0.data_ptr(), xa.data_ptr(), xb.data_ptr(), skip.data_ptr(), sp.data_ptr(),
                    zc.data_ptr(), cond.data_ptr(), step.data_ptr(), *(a.data_ptr() for a in w),
                    b, t, C, H, L, group, nwg, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"K1-bf16 ({group}, {nwg}): CUDA error {err}")
                return skip

            err = peak_err(call(), want)
            row[f"{group}x{nwg}"] = (round(timed_ms(call, 20, torch), 5), round(err, 6))
        row["wrapper"] = round(timed_ms(lambda: wn.residual_stack(x0, cond, step, w), 20, torch), 5)
        emit("k1_schedules", b=b, t=t, ms_err=row)


def in_turns(parent_k1, parent_stage, torch, dev, variants=None, k1_variants=None):
    from prodiff_tpu_torch.ops import wavenet_stack as wn
    from prodiff_tpu_torch.ops.resblock import resblock_stage, resblock_stage_plain

    rng = np.random.default_rng(23)
    w = k1_weights(rng, dev, torch, L)
    for b, t in K1_SHAPES:
        x0, cond, step = (rand(rng, dev, torch, b, t, C), rand(rng, dev, torch, b, t, H),
                          rand(rng, dev, torch, b, C))
        want = wn.residual_stack_plain(x0, cond, step, w)
        fns = {"parent": lambda: parent_k1(x0, cond, step, w),
               "this": lambda: wn.residual_stack(x0, cond, step, w)}
        for name, fn in (k1_variants or {}).items():
            fns[name] = lambda fn=fn: fn(x0, cond, step, w)
        errs = {k: peak_err(f(), want) for k, f in fns.items()}
        times = {k: [] for k in fns}
        for k in ("parent", "this", *(k1_variants or {}), "this", "parent"):
            times[k].append(timed_ms(fns[k], 20, torch))
        emit("k1_in_turns", b=b, t=t, err_of_peak=errs, ms=times)
    for c, t in RES_STAGES:
        w = torch.cat([rand(rng, dev, torch, k * c * c, scale=(k * c) ** -0.5)
                       for k in RES_K for _ in range(6)]).to(torch.bfloat16)
        biases, x = rand(rng, dev, torch, 18, c, scale=0.1), rand(rng, dev, torch, 1, t, c)
        want = resblock_stage_plain(x, w, biases, RES_K, RES_D)
        fns = {"parent": lambda: parent_stage(x, w, biases, RES_K, RES_D),
               "this": lambda: resblock_stage(x, w, biases, RES_K, RES_D)}
        for name, fn in (variants or {}).items():
            fns[name] = lambda fn=fn: fn(x, w, biases, RES_K, RES_D)
        errs = {k: peak_err(f(), want) for k, f in fns.items()}
        times = {k: [] for k in fns}
        for k in ("parent", "this", *(variants or {}), "this", "parent"):
            times[k].append(timed_ms(fns[k], 20, torch))
        emit("stage_in_turns", c=c, t=t, err_of_peak=errs, ms=times)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", required=True, help="a checkout of the earlier version")
    parser.add_argument("--out", default=os.path.join(ROOT, "build", "probe_bf16_kernels.json"))
    parser.add_argument("--skip-split", action="store_true", help="only the in-turns times")
    parser.add_argument("--k5-only", action="store_true",
                        help="only K5a/K5b-bf16: both versions in turns, split by kernel")
    parser.add_argument("--c8-only", action="store_true",
                        help="only K2 / K2-bf16 at C = 8: both versions split and in turns")
    parser.add_argument("--c8-variants", default="",
                        help="name=DEFINE[;DEFINE],... : builds of this checkout's resblock.cu "
                             "and resblock_bf16.cu with defines (C8_SKIP), split beside it")
    parser.add_argument("--lvc-only", action="store_true",
                        help="only K4-bf16: both versions at the LJSpeech blocks, in turns")
    parser.add_argument("--lvc-variants", default="",
                        help="name=DEFINE[;DEFINE],... : builds of this checkout's ublock.cu "
                             "with defines (LVCT_SKIP), timed beside it")
    parser.add_argument("--k5-variants", default="",
                        help="name=DEFINE[;DEFINE],... : builds of this checkout's "
                             "wavenet_train_bf16.cu with defines, timed in turns beside it")
    parser.add_argument("--k1-schedules", default="",
                        help="group x warpgroups,... (e.g. 20x2,10x1): K1-bf16 timed at each")
    parser.add_argument("--stage-variants", default="",
                        help="name=DEFINE[;DEFINE],... : builds of this checkout's "
                             "resblock_bf16.cu with defines, timed in turns beside it")
    parser.add_argument("--k1-variants", default="",
                        help="name=DEFINE,... : the same for wavenet_stack_bf16.cu")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe: no CUDA card")
    from prodiff_tpu_torch import device as policy
    from prodiff_tpu_torch.ops import cuda_build

    policy.set_precision(policy.PARITY)
    dev = torch.device("cuda:0")
    import subprocess

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    emit("card", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    t0 = time.time()
    plain = parent_sources(os.path.abspath(args.parent), False)
    if args.c8_only:
        defines = {name: tuple(d.split(";")) for name, d in
                   (item.split("=", 1) for item in filter(None, args.c8_variants.split(",")))}
        try:
            cuda_build.load_all(["resblock", "resblock_bf16"]
                                + [(n, d) for d in defines.values() for n, _ in C8_ENTRIES.values()])
        except RuntimeError as e:
            emit("build_this_failed", error=str(e)[-6000:])
        else:
            emit("build_this", ptxas={n: [ln.strip() for ln in cuda_build.build_log(n).splitlines()
                                          if "registers" in ln or "spill" in ln]
                                      for n in ("resblock", "resblock_bf16")})
            variants = {dt: {f"this_{v}": ParentStage(cuda_build.load(n, d), torch, fn)
                             for v, d in defines.items()} for dt, (n, fn) in C8_ENTRIES.items()}
            c8_probe(os.path.abspath(args.parent), torch, dev, variants)
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        return 0 if not any(r["probe"] == "build_this_failed" for r in records) else 1
    if args.lvc_only:
        parent_k4 = LvcBuild(torch, build_variant("ublock", plain, "PARENT"))
        emit("build_parent", seconds=round(time.time() - t0, 3))
        defines = {name: tuple(d.split(";")) for name, d in
                   (item.split("=", 1) for item in filter(None, args.lvc_variants.split(",")))}
        try:
            cuda_build.load_all(["ublock"] + [("ublock", d) for d in defines.values()])
        except RuntimeError as e:
            emit("build_this_failed", error=str(e)[-6000:])
        else:
            from prodiff_tpu_torch.ops.ublock import ublock_layer

            emit("build_this", ptxas=[ln.strip() for ln in cuda_build.build_log(
                "ublock").splitlines() if "registers" in ln or "spill" in ln])
            builds = {"earlier": parent_k4.layer, "this": ublock_layer}
            builds.update({name: LvcBuild(torch, cuda_build.load("ublock", d)).layer
                           for name, d in defines.items()})
            lvc_probe(builds, torch, dev)
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        return 0 if not any(r["probe"] == "build_this_failed" for r in records) else 1
    if args.k5_only:
        k5_lib = build_variant("wavenet_train_bf16", plain, "PARENT")
        emit("build_parent", seconds=round(time.time() - t0, 3))
        k5_defines = {name: tuple(d.split(";")) for name, d in
                      (item.split("=", 1) for item in filter(None, args.k5_variants.split(",")))}
        try:
            cuda_build.load_all(["wavenet_train_bf16"]
                                + [("wavenet_train_bf16", d) for d in k5_defines.values()])
        except RuntimeError as e:
            emit("build_this_failed", error=str(e)[-6000:])
        else:
            emit("build_this", ptxas=[ln.strip() for ln in cuda_build.build_log(
                "wavenet_train_bf16").splitlines() if "registers" in ln or "spill" in ln])
            k5_probe(ParentK5(k5_lib, torch), torch, dev,
                     shapes=K5_SHAPES[:1] if k5_defines else K5_SHAPES, variants={
                name: variant_k5(cuda_build.load("wavenet_train_bf16", d))
                for name, d in k5_defines.items()})
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        return 0 if not any(r["probe"] == "build_this_failed" for r in records) else 1
    stamped = parent_sources(os.path.abspath(args.parent), True)
    k1_lib = build_variant("wavenet_stack_bf16", plain, "PARENT")
    res_lib = build_variant("resblock_bf16", plain, "PARENT")
    k1_stamped = build_variant("wavenet_stack_bf16", stamped, "STAMPED")
    emit("build_parent", seconds=round(time.time() - t0, 3))
    parent_k1, parent_stage = ParentK1(k1_lib, torch), ParentStage(res_lib, torch)
    if not args.skip_split:
        k1_split(ParentK1(k1_stamped, torch), torch, dev)
        stage_split(parent_stage, torch, dev)
    # name=DEFINE[;DEFINE...]
    defines = {name: tuple(d.split(";")) for name, d in
               (item.split("=", 1) for item in filter(None, args.stage_variants.split(",")))}
    k1_defines = {name: tuple(d.split(";")) for name, d in
                  (item.split("=", 1) for item in filter(None, args.k1_variants.split(",")))}
    try:
        cuda_build.load_all(["wavenet_stack_bf16", "resblock_bf16"]
                            + [("resblock_bf16", d) for d in defines.values()]
                            + [("wavenet_stack_bf16", d) for d in k1_defines.values()])
    except RuntimeError as e:  # this checkout's build: reported, and nothing timed in turns
        emit("build_this_failed", error=str(e)[-6000:])
    else:
        emit("build_this", ptxas={
            n: [ln.strip() for ln in cuda_build.build_log(n).splitlines() if "registers" in ln
                or "spill" in ln] for n in ("wavenet_stack_bf16", "resblock_bf16")})
        variants = {name: ParentStage(cuda_build.load("resblock_bf16", d), torch)
                    for name, d in defines.items()}
        k1_variants = {name: variant_k1(cuda_build.load("wavenet_stack_bf16", d), torch)
                       for name, d in k1_defines.items() if d != ("K1_STAMPS=1",)}
        if ("K1_STAMPS=1",) in k1_defines.values():
            lib = cuda_build.load("wavenet_stack_bf16", ("K1_STAMPS=1",))
            lib.wavenet_read_stamps_bf16.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.wavenet_clear_stamps_bf16.restype = ctypes.c_int
            k1_phases(lib, torch, dev)
        if args.k1_schedules:
            k1_schedules(torch, dev, [tuple(int(v) for v in item.split("x"))
                                      for item in args.k1_schedules.split(",")])
        in_turns(parent_k1, parent_stage, torch, dev, variants, k1_variants)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(records, f, indent=1)
    return 0 if not any(r["probe"] == "build_this_failed" for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
