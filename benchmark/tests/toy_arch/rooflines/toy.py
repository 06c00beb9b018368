"""The stub architecture's operations: 2 x the multiply-adds of its layers'
products, on every sequence-site."""


def forward_flop(n: int, l: int, sizes) -> int:
    return 2 * n * l * sizes["n_layers"] * sizes["width"] ** 2
