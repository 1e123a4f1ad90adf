#!/usr/bin/env python3
"""Main simulation CLI — env-compatible with the reference driver.

All configuration is the QD_* environment surface (see docs/runtime-config.md
and /root/reference/docs/04-runtime-config.md); duration priority is
QD_TOTAL_YEARS > QD_SIM_DAYS > 5 planetary years, restart priority is
QD_RESTART_IN > data/atmosphere.nc autosave > banded/default init.

Usage:
  QD_SIM_DAYS=10 python -m scripts.run_simulation
"""

import os
import sys

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    print("--- Initializing Qingdai GCM ---")
    print(f"[JAX] devices: {jax.devices()}")
    from qingdai_tpu.world import QingdaiWorld
    world = QingdaiWorld.create_default()
    world.run()


if __name__ == "__main__":
    main()
