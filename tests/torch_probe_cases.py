"""Copy schedules beyond the seven Pallas probes, shared by the CPU tests
(``test_torch_probes.py``: the plain version against the ring run copy by
copy) and the GPU tests (``test_torch_cuda.py``: the kernel bit-equal to the
plain version). Imports neither JAX nor its package."""
from juliaraytracingsw_tpu_torch.ops.probes import CopySchedule

# (the schedule, x's shape)
EXTRA_COPY_SCHEDULES = [
    # 48-byte copies (q = 3, W = 4), 2 slots, 2 in flight
    (CopySchedule(q=3, n_copies=7, n_slots=2, in_flight=2), (32, 4)),
    # 37 copies from an odd src_mod into 5 slots, 5 in flight, 2 slices each
    (CopySchedule(q=8, n_copies=37, src_mod=61, n_slots=5, in_flight=5), (72, 128)),
    # 20 copies into 5 slots, 3 in flight: slot reuse crosses the in-flight
    # mbarriers, so one thread starts every copy
    (CopySchedule(q=2, n_copies=20, src_mod=33, n_slots=5, in_flight=3), (40, 8)),
    # one 256 KB copy, cut into 128 slices
    (CopySchedule(q=512), (512, 128)),
    # the plain mode on rows of 6 floats (no 16-byte accesses) ...
    (CopySchedule(q=5, n_copies=3, staged=False), (16, 6)),
    # ... and of 260, with a wrap and 3 slots
    (CopySchedule(q=4, n_copies=9, src_mod=13, n_slots=3, in_flight=3, staged=False),
     (20, 260)),
]
