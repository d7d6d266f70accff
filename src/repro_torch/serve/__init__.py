from repro_torch.serve.step import make_prefill, make_serve_step  # noqa: F401
