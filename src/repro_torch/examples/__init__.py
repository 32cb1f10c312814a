"""Runnable examples of the port (counterparts of the reference's
`examples/`), each on the CUDA card unless ``--device cpu`` asks for the
CPU:

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
  PYTHONPATH=src python -m repro_torch.examples.serve_engine [--device cpu]
  PYTHONPATH=src python -m repro_torch.examples.serve_cluster [--workers 8] [--rps 0.8]
  PYTHONPATH=src python -m repro_torch.examples.train_100m [--steps 300] [--device cpu]
"""
