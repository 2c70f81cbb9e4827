"""One stderr line of device facts from a command that ran on a device.

`[device] {json}` names the platform, the device kind and count, each
device's peak_bytes_in_use (None where the backend keeps no statistics),
whether the native library is loaded, and for the overlap engine the ids of
the devices its read lanes were placed on.  A parent process that must not
open the device itself (one JAX process per card) reads these lines.
"""
from __future__ import annotations

import json
import sys
from typing import Iterable, Optional

import jax

PREFIX = "[device] "


def report(stage: str, lane_devices: Optional[Iterable[int]] = None) -> dict:
    from .. import native

    devices = jax.local_devices()
    info = {
        "stage": stage,
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
        "peak_bytes_in_use": [
            (d.memory_stats() or {}).get("peak_bytes_in_use") for d in devices
        ],
        "native": native.available(),
    }
    if lane_devices is not None:
        info["lane_devices"] = sorted(set(lane_devices))
    print(PREFIX + json.dumps(info), file=sys.stderr, flush=True)
    return info

