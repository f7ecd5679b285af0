"""The paper's table and figure scripts on the port
(``python -m repro_torch.benchmarks.<name>``); each ``run()`` returns the
original script's rows."""
