"""Token sampling shared by the models' generate loops."""

import torch


def pick_token(logits, temperature, gen):
    """Greedy argmax, or a sample from softmax(logits / t) with ``gen``."""
    if not temperature or temperature <= 0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / max(float(temperature), 1e-6), -1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0]
