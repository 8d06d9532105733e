"""Offline tools (reference analogue: utils/mat2ijbin.c,
utils/lsseq_driver.c, SURVEY.md §2.8) and the ports of the JAX package's
scripts around it: ``profile_setup``, ``profile_solve``, ``node_scaling``,
``parity_report``, ``bindings`` (the ``interfaces/`` bindings on this
package's C shim), ``generate_example_output``, ``plot_convergence``,
``spyplot``, ``spmat_reorder``, ``fuzz_loop`` and ``bench_kernels`` (the
counterpart of the three TPU kernel micro-benchmarks)."""
