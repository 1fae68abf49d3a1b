from tpustereo_torch.data.synthetic import synthetic_pair  # noqa: F401
