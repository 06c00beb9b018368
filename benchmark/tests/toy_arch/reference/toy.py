"""The stub architecture's plain reference, in float64: the weights the
benchmark makes from the seed, and each pair's distance."""

from __future__ import annotations

import itertools

import torch


def weights(sizes, seed: int, device: torch.device):
    g = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    w = sizes["width"]
    return {"embed": torch.randn(sizes["n_symbols"], w, generator=g, device=device),
            "layers": torch.randn(sizes["n_layers"], w, w, generator=g, device=device) / w ** 0.5}


def predict(weights, codes) -> torch.Tensor:
    h = weights["embed"].double().cpu()[torch.as_tensor(codes).long()]
    for layer in weights["layers"].double().cpu():
        h = h + torch.tanh(torch.einsum("nlw,wv->nlv", h, layer))
    z = h.mean(1)
    n = len(z)
    return torch.stack([torch.log1p(torch.exp(((z[a] - z[b]) ** 2).sum()))
                        for a, b in itertools.combinations(range(n), 2)])
