"""Small shape/layout helpers shared by ops, kernels, and dist."""


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return ceil_div(x, m) * m
