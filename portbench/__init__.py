"""The benchmark of msgwam's PyTorch and CUDA port (``msgwam_tpu_torch``)
on one NVIDIA H100: ``python -m portbench --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` (:mod:`portbench.run`).  The cells, metrics
and configurations are named in ``BENCHMARK.json`` at the checkout's root;
their files sit here, one each (:mod:`portbench.manifest`).  Nothing here
imports JAX or the JAX package, and the reference (:mod:`portbench.
reference`) imports nothing of the port."""
