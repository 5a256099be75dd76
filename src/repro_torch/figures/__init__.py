"""The paper's figures from the analytic model (copies of the reference's
``benchmarks/fig*.py``); ``python -m repro_torch.figures.run`` prints them."""
