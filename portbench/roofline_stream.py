"""The whole-run kernel's bound where the rays outnumber what any kernel
can hold on chip: the bytes of the rays that have to live in device memory
between stages, counted beside :mod:`portbench.roofline`'s.

``roofline.whole_run_step_s`` counts the state once a launch (57 B a ray),
which holds while the whole state stays on chip from the launch's start
to its end.  Past the card's on-chip storage it does not: a stage's update
of a ray needs the flux that every ray's previous stage deposited, so the
grid-wide wait between stages splits each stage from the next, and nothing
can carry a ray's state over that wait except storage.  A ray that the
card's registers and shared memory cannot hold is read from and written to
device memory in the stages that need it.  Of its float32s, the state
(dens, r, m) is 12 B, the RK3 accumulator (qd, qr, qm) 12 B and the
frozen terms 32 B:

* every stage reads and writes the state, 24 B, and reads the frozen
  terms, 32 B;
* stage 1 starts the accumulator afresh (q = dt · rhs), so it reads no q;
  stages 2 and 3 read it, 12 B each;
* stage 3 ends the step with the accumulator spent, and the next step's
  stage 1 overwrites it unread, so it writes no q; stages 1 and 2 write
  it, 12 B each.

3 × (24 + 32) + 2 × 12 + 2 × 12 = 216 B a ray a step: the least any kernel
moves, whatever it does with the q of stage 3.

The capacity C is the card's, from NVIDIA's data sheet for the H100 SXM
and not from any kernel's plan, so the bound reads the same work whatever
kernel does it: 132 SMs × (256 KiB of registers + 228 KiB of shared
memory) = 65,421,312 B, over the 56 B a held ray needs (its six state
floats and eight frozen terms as float32): C = 1,168,238 rays, rounded up
so that the bound stays a least time.  The 50 MB L2 is not counted: it is
a cache, and cannot hold the state from one stage to the next reliably.

So the bound of one whole step of n rays is the larger of the operations
(``roofline.step_ops``) and the bytes ``57 n / steps_per_launch + 216 ×
max(0, n - C)`` over the peaks of :mod:`portbench.roofline`; at n ≤ C it is
``roofline.whole_run_step_s`` itself.
"""

from __future__ import annotations

from portbench import roofline

SMS = 132
REGISTER_BYTES_PER_SM = 256 * 1024
SHARED_BYTES_PER_SM = 228 * 1024
ON_CHIP_BYTES = SMS * (REGISTER_BYTES_PER_SM + SHARED_BYTES_PER_SM)
HELD_RAY_BYTES = 4 * (6 + 8)
CAPACITY_RAYS = -(-ON_CHIP_BYTES // HELD_RAY_BYTES)
STATE_BYTES = 4 * 3
RK3_BYTES = 4 * 3
FROZEN_BYTES = 4 * 8
STREAM_STEP_BYTES = (3 * (2 * STATE_BYTES + FROZEN_BYTES)
                     + 2 * RK3_BYTES + 2 * RK3_BYTES)


def step_bytes(n: int, steps_per_launch: int) -> float:
    """The least bytes of one whole step of ``n`` rays moved through
    device memory: the launch's state shared by its steps, and the rays
    past the on-chip capacity in and out every stage."""
    return (roofline.WHOLE_RUN_BYTES_PER_RAY * n / steps_per_launch
            + STREAM_STEP_BYTES * max(0, n - CAPACITY_RAYS))


def whole_run_step_s(n: int, cells: float, steps_per_launch: int,
                     deposit: bool) -> float:
    """The whole-run kernel's bound for one step of ``n`` rays, with
    :func:`roofline.whole_run_step_s`'s arguments."""
    return roofline.bound_s(step_bytes(n, steps_per_launch),
                            roofline.step_ops(n, cells, deposit))
