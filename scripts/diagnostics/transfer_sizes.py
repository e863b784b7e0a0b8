#!/usr/bin/env python
"""Host->device transfer diagnostic (reference: scripts/diagnostics
transfer-size checks): measures H2D and D2H bandwidth across buffer sizes
so transfer-bound ingest numbers (Hybrid mode, finalize) can be
attributed."""

import time

import numpy as np


def main():
    import jax

    dev = [d for d in jax.devices() if d.platform != "cpu"]
    if not dev:
        print("no accelerator device; nothing to measure")
        return 0
    dev = dev[0]
    print(f"device: {dev}")
    for mb in (1, 4, 16, 64):
        buf = np.zeros(mb * (1 << 20) // 4, np.int32)
        # warm
        jax.device_put(buf, dev).block_until_ready()
        t0 = time.perf_counter()
        x = jax.device_put(buf, dev)
        x.block_until_ready()
        h2d = time.perf_counter() - t0
        t0 = time.perf_counter()
        _ = np.asarray(x)
        d2h = time.perf_counter() - t0
        print(f"{mb:3d} MB  H2D {mb / h2d:7.1f} MB/s   "
              f"D2H {mb / d2h:7.1f} MB/s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
