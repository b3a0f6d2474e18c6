"""One rank of a gloo CPU sp group for ``tests/test_torch_ring_attention.py``.

    python tests/torch_sp_worker.py RANK WORLD INIT_METHOD IN_DIR OUT_FILE

Reads the inputs the test wrote to ``IN_DIR`` (numpy arrays, a torch state
dict), runs the port's ring attention on this rank's piece of each case,
forward and backward, and (at world 2) one ``SPTrainer`` step of a tiny
Transformer and a ring over a one-rank subgroup; writes this rank's
results to ``OUT_FILE`` with ``torch.save``. Imports only the port.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from torchft_tpu_torch.models.transformer import (Transformer,
                                                  plain_attention,
                                                  tiny_config)
from torchft_tpu_torch.parallel.ring_attention import make_ring_attention
from torchft_tpu_torch.parallel.step import SPTrainer


def _piece(x: np.ndarray, rank: int, world: int) -> torch.Tensor:
    s_loc = x.shape[1] // world
    return torch.tensor(x[:, rank * s_loc:(rank + 1) * s_loc])


def main(rank: int, world: int, init: str, in_dir: str, out: str) -> None:
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    ring = make_ring_attention()
    res = {}
    for causal in (True, False):
        arrays = np.load(os.path.join(in_dir, f"ring_{int(causal)}.npz"))
        q, k, v = (_piece(arrays[n], rank, world).requires_grad_()
                   for n in ("q", "k", "v"))
        out_ = ring(q, k, v, causal)
        (out_ * _piece(arrays["g"], rank, world)).sum().backward()
        res[f"ring_{int(causal)}"] = [t.detach() for t in
                                      (out_, q.grad, k.grad, v.grad)]
    if world == 2:
        step = torch.load(os.path.join(in_dir, "step.pt"))
        cfg = tiny_config(dtype=torch.float32, num_kv_heads=2, num_layers=1,
                          attention_fn=ring)
        model = Transformer(cfg, device="cpu")
        model.load_state_dict(step["params"], strict=True)
        trainer = SPTrainer(model, torch.optim.AdamW(
            model.parameters(), lr=3e-4, weight_decay=1e-4, eps=1e-8))
        loss = trainer.train_step(step["tokens"])
        res["step"] = {
            "loss": loss, "grads": {n: p.grad for n, p in
                                    model.named_parameters()},
            "params": {n: p.detach() for n, p in model.named_parameters()}}
        # Every rank joins new_group; the one-rank ring is plain attention.
        one = dist.new_group([0])
        if rank == 0:
            res["one_rank_is_plain"] = make_ring_attention(one) is \
                plain_attention
    torch.save(res, out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
