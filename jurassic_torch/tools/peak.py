"""Measured peak rates of the CUDA card (port of ``tools/vpu_peak.py``).

The fused EGA kernels do float32 arithmetic, transcendentals and
data-dependent table reads, no matrix products, so their bound is set by
the card's FP32 instruction rate, its special-function rate and its memory
rate.  This tool measures the three on THIS card with the probes of
``csrc/peak_probes.cu``:

  fma_tflops    float32 FMA throughput (2 operations per FMA), NACC
                independent chains per thread, no memory traffic;
  sfu_gops      special-function rate, the same harness on ``__expf``,
                ``ex2.approx`` and ``lg2.approx``;
  hbm_copy_gbs  a float4 copy of a buffer far larger than the L2 cache
                (read + written bytes per second).

Rates come from timing two problem sizes with CUDA events and dividing
the extra work by the extra time (``tools/vpu_peak.py:96-103``).  Each
probe has a plain PyTorch version of the same function (``*_ref``), which
the CPU gets and which the kernels are held against at a small loop
count.  ``LAUNCHES`` counts probe-kernel launches by name.

Run ``python -m jurassic_torch.tools.peak`` on a machine with a card: it
prints one JSON line.  :func:`measure` caches the result per device name
in ``jurassic_torch/_build/``.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess

import torch

from ..ops._build import BUILD_DIR, load_library

# layout of csrc/peak_probes.cu
NACC = 8          # independent chains per thread
INNER = 32        # fma steps of every chain per loop iteration
SFU_INNER = 8     # sfu steps of every chain per loop iteration
THREADS = 256     # threads per block
FMA_X, FMA_C = 0.999, 0.001     # acc <- acc * x + c, fixed point 1
SFU_OPS = ("expf", "ex2", "lg2")

# what measure() runs
BLOCKS_PER_SM = 16              # fills every SM several times over
LOOPS = 2048                    # fma loop count of one unit of work
SFU_LOOPS = LOOPS * INNER // SFU_INNER   # the same chain steps per unit
COPY_BYTES = 1 << 30            # bytes of one unit, far beyond the L2
REPS = 5                        # timed runs per point, median taken

LAUNCHES = {"fma": 0, "sfu": 0, "copy": 0}


def probe_init(blocks: int, device="cpu", seed: int = 0) -> torch.Tensor:
    """Starting accumulators [blocks * THREADS, NACC] f32 in (0.1, 0.9),
    from a seed."""
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((blocks * THREADS, NACC), generator=g,
                   dtype=torch.float32)
    return (0.1 + 0.8 * x).to(device)


def fma_steps(init: torch.Tensor, steps: int, x: float = FMA_X,
              c: float = FMA_C) -> torch.Tensor:
    """acc <- fma(acc, x, c), ``steps`` times, in plain PyTorch: the
    product and sum in float64 (exact for float32 factors), rounded to
    float32 once per step like the fused instruction."""
    acc = init.clone()
    x = float(torch.tensor(x, dtype=torch.float32))
    c = float(torch.tensor(c, dtype=torch.float32))
    for _ in range(steps):
        acc = (acc.double() * x + c).float()
    return acc


def fma_ref(init: torch.Tensor, loops: int) -> torch.Tensor:
    """The plain version of the fma probe: ``loops * INNER`` steps."""
    return fma_steps(init, loops * INNER)


def sfu_steps(init: torch.Tensor, op: str, steps: int) -> torch.Tensor:
    """The special-function recurrence ``op`` of SFU_OPS, ``steps``
    times, in plain PyTorch.  Each map contracts to a fixed point
    (``expf``: acc <- exp(-acc), by 0.57 per step; ``ex2``: 2^-acc, 0.44;
    ``lg2``: log2(acc + 1.5), 0.46, and no steeper than 0.9 anywhere on
    the way, so rounding errors shrink too).  The result therefore tells
    the step count only while the chain is still on its way: at 1e-5 up
    to about 16 steps for ``expf``, 8 for ``ex2`` and ``lg2``."""
    if op not in SFU_OPS:
        raise ValueError(f"op must be one of {SFU_OPS}")
    acc = init.clone()
    for _ in range(steps):
        if op == "expf":
            acc = torch.exp(-acc)
        elif op == "ex2":
            acc = torch.exp2(-acc)
        else:
            acc = torch.log2(acc + 1.5)
    return acc


def sfu_ref(init: torch.Tensor, op: str, loops: int) -> torch.Tensor:
    """The plain version of the sfu probe: ``loops * SFU_INNER`` steps."""
    return sfu_steps(init, op, loops * SFU_INNER)


def copy_ref(src: torch.Tensor) -> torch.Tensor:
    return src.clone()


def _launch(name: str, x: torch.Tensor, call):
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("probe tensors are contiguous float32")
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = ctypes.c_void_p(
            torch.cuda.current_stream(x.device).cuda_stream)
        rc = call(lib, stream)
    if rc != 0:
        raise RuntimeError(f"peak probe {name}: launch failed "
                           f"(cudaError {rc})")
    LAUNCHES[name] += 1


def _blocks(init: torch.Tensor) -> int:
    n = init.shape[0]
    if init.dim() != 2 or init.shape[1] != NACC or n % THREADS or n == 0:
        raise ValueError(f"init must be [blocks * {THREADS}, {NACC}]")
    return n // THREADS


def fma_probe(init: torch.Tensor, loops: int) -> torch.Tensor:
    """:func:`fma_ref` as the CUDA probe for CUDA tensors (or an error),
    the plain version for CPU tensors."""
    if init.device.type == "cpu":
        return fma_ref(init, loops)
    if init.device.type != "cuda":
        raise ValueError(f"unsupported device {init.device}")
    blocks = _blocks(init)
    out = torch.empty_like(init)
    _launch("fma", init, lambda lib, st: lib.jt_peak_fma(
        init.data_ptr(), out.data_ptr(), FMA_X, FMA_C, loops, blocks, st))
    return out


def sfu_probe(init: torch.Tensor, op: str, loops: int) -> torch.Tensor:
    """:func:`sfu_ref` as the CUDA probe for CUDA tensors (or an error),
    the plain version for CPU tensors."""
    if init.device.type == "cpu":
        return sfu_ref(init, op, loops)
    if init.device.type != "cuda":
        raise ValueError(f"unsupported device {init.device}")
    blocks = _blocks(init)
    code = SFU_OPS.index(op)
    out = torch.empty_like(init)
    _launch("sfu", init, lambda lib, st: lib.jt_peak_sfu(
        init.data_ptr(), out.data_ptr(), code, loops, blocks, st))
    return out


def copy_probe(src: torch.Tensor, blocks: int) -> torch.Tensor:
    """:func:`copy_ref` as the CUDA float4 copy probe on ``blocks``
    blocks for CUDA tensors (or an error), the plain version for CPU
    tensors.  ``src`` is flat float32, a multiple of 4 long."""
    if src.device.type == "cpu":
        return copy_ref(src)
    if src.device.type != "cuda":
        raise ValueError(f"unsupported device {src.device}")
    if src.dim() != 1 or src.numel() % 4 or src.data_ptr() % 16:
        raise ValueError("src must be flat, a multiple of 4 long and "
                         "16-byte aligned")
    out = torch.empty_like(src)
    _launch("copy", src, lambda lib, st: lib.jt_peak_copy(
        src.data_ptr(), out.data_ptr(), src.numel() // 4, blocks, st))
    return out


def two_point_rate(work: float, t1: float, t2: float) -> float:
    """Work per second from the times of one and two units of work: the
    second unit took ``t2 - t1`` (launch and tail costs cancel)."""
    return work / max(t2 - t1, 1e-9)


def cuda_seconds(fn) -> float:
    """Median seconds of fn() over REPS runs, CUDA events, after one
    warm-up run."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e-3)
    return statistics.median(times)


def smi(query: str) -> str:
    """One nvidia-smi query field of the first card, as text."""
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def _cache_file(kind: str):
    return BUILD_DIR / ("peak_" + kind.replace(" ", "_") + ".json")


def measure(force: bool = False) -> dict:
    """The card's measured rates (module docstring), cached per device
    name in ``jurassic_torch/_build/``.  Needs a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("the peak probes need a CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    kind = torch.cuda.get_device_name(dev)
    cache = _cache_file(kind)
    if cache.exists() and not force:
        return json.loads(cache.read_text())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = sms * BLOCKS_PER_SM
    init = probe_init(blocks, dev)
    steps = blocks * THREADS * NACC * INNER * LOOPS   # chain steps / unit
    t1 = cuda_seconds(lambda: fma_probe(init, LOOPS))
    t2 = cuda_seconds(lambda: fma_probe(init, 2 * LOOPS))
    out = {"device_kind": kind, "card": smi("name,power.limit"),
           "sm_count": sms, "blocks": blocks,
           "clocks_sm_mem_mhz": smi("clocks.sm,clocks.mem"),
           "fma_tflops": two_point_rate(2 * steps, t1, t2) / 1e12,
           "t_fma": [t1, t2], "sfu_gops": {}, "t_sfu": {}}
    for op in SFU_OPS:
        e1 = cuda_seconds(lambda: sfu_probe(init, op, SFU_LOOPS))
        e2 = cuda_seconds(lambda: sfu_probe(init, op, 2 * SFU_LOOPS))
        out["sfu_gops"][op] = two_point_rate(steps, e1, e2) / 1e9
        out["t_sfu"][op] = [e1, e2]
    n = COPY_BYTES // 4
    src = torch.empty(2 * n, dtype=torch.float32, device=dev).uniform_()
    c1 = cuda_seconds(lambda: copy_probe(src[:n], blocks))
    c2 = cuda_seconds(lambda: copy_probe(src, blocks))
    out["hbm_copy_gbs"] = two_point_rate(2.0 * COPY_BYTES, c1, c2) / 1e9
    out["t_copy"] = [c1, c2]
    out["chain_steps"] = steps
    out["copy_bytes"] = COPY_BYTES
    cache.parent.mkdir(parents=True, exist_ok=True)
    cache.write_text(json.dumps(out))
    return out


if __name__ == "__main__":
    print(json.dumps(measure(force=True)))
