"""Multi-process training on the PyTorch port over a ("data", "model")
mesh.  The port of ``examples/sharded_training.py``: shard the dataset and
every verb -- training, inference, readouts -- runs on each rank's rows
with its EM statistics summed by all_reduce.

    PYTHONPATH=. python examples/torch_port/sharded_training.py [--device cuda|cpu]

The script starts its own ranks (spawned processes, a file store in a
temporary directory): one per card with NCCL on the card (NCCL takes one
rank a card), two with gloo on the CPU.
"""

import argparse
import tempfile

import numpy as np
import torch

N, D = 100_001, 32


def rank_main(rank: int, world: int, store: str, device: str) -> None:
    import ppca_rs_tpu_torch
    from ppca_rs_tpu_torch import Dataset, PPCATrainer, iterate_streamed
    from ppca_rs_tpu_torch.parallel import distributed, make_mesh, shard_dataset

    ppca_rs_tpu_torch.config.device = torch.device(device)
    distributed.initialize(init_method=f"file://{store}", world_size=world, rank=rank,
                           local_rank=rank if device == "cuda" else None)
    say = print if rank == 0 else (lambda *a, **k: None)
    device = ppca_rs_tpu_torch.config.device

    rng = np.random.default_rng(0)
    C_true = rng.normal(size=(D, 4))
    data = rng.normal(size=(N, 4)) @ C_true.T + 0.3 * rng.normal(size=(N, D))
    data[rng.random(data.shape) < 0.25] = np.nan

    mesh = make_mesh()  # all ranks on the 'data' axis
    dataset = shard_dataset(Dataset(data, device=device), mesh)
    say(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))}, dataset: {len(dataset)} rows, "
        f"{len(dataset.data)} on rank 0")

    model = PPCATrainer(dataset).train(state_size=4, n_iters=10, quiet=rank != 0,
                                       generator=torch.Generator(device).manual_seed(1))
    filled = model.extrapolate(dataset)
    missing = int(np.isnan(filled.numpy()).sum())
    say("imputed NaNs:", missing, "(should be 0)")
    assert missing == 0
    say(model)

    # More iterations with the llk trace, nothing copied to the host
    # between them.
    model2, llks = model.iterate_n(dataset, 5)
    llks = llks.double().cpu().numpy()
    # monotone up to float32 reduction noise (llk totals are ~1e6 here)
    assert np.all(np.diff(llks) > -1e-6 * np.abs(llks[:-1])), "plain EM llk is monotone"
    say(f"5 more iterations: llk {llks[0]:.1f} -> {model2.llk(dataset):.1f}")

    # Sharded chunks also stream: a fleet can train on datasets larger than
    # its combined device memory by accumulating per-chunk EM statistics.
    half = N // 2
    chunks = [shard_dataset(Dataset(data[:half], device=device), mesh),
              shard_dataset(Dataset(data[half:], device=device), mesh)]
    streamed, llk_s = iterate_streamed(model2, chunks)
    single = model2.iterate(dataset)
    assert np.isclose(llk_s, model2.llk(dataset), rtol=1e-5)
    assert torch.allclose(streamed.transform, single.transform, rtol=1e-4, atol=1e-5)
    say(f"streamed == single-shot iteration: llk {llk_s:.1f}")
    say("ok: sharded training, repeated iterations, and sharded streaming agree")
    torch.distributed.destroy_process_group()


def main() -> None:
    parser = argparse.ArgumentParser(description="Train on a dataset sharded over ranks.")
    parser.add_argument("--device", default="cuda", help="cuda (NCCL, a rank per card) or cpu")
    device = parser.parse_args().device
    world = torch.cuda.device_count() if device == "cuda" else 2
    if world < 1:
        raise RuntimeError("--device cuda needs a card")
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.start_processes(rank_main, args=(world, f"{tmp}/store", device),
                                              nprocs=world, start_method="spawn")


if __name__ == "__main__":
    main()
