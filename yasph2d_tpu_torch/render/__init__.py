"""yasph2d_tpu_torch.render: the headless camera and particle renderer (host
NumPy and C++; a copy of yasph2d_tpu/render)."""
