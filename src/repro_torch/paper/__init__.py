"""The paper's experiments on the port (twins of the reference's
``benchmarks/table1_entropy.py``, ``table2_bits.py``,
``table3_performance.py``, ``table4_comm.py``, ``quant_bench.py``'s
adaptive-wire curve and ``roofline.py``'s weight-bytes rows):
``python -m repro_torch.paper.run``.  Each returns its table and prints
the reference's ``name,us_per_call,derived`` rows; none writes a file
unless its caller names one."""
