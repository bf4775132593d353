"""Whether gloo's point-to-point send and recv move a CUDA tensor: two
gloo ranks on one card, rank 0 sends 4 MB of a CUDA tensor to rank 1.

    python scripts/torch_gloo_p2p_probe.py

Prints each rank's exit code and last lines.  On an H100 the sender
aborted (`gloo::IoException ... writev: Bad address`: gloo reads the
device pointer as host memory), which is why `parallel/pipeline.py`
stages a gloo group's CUDA tensors through pinned host memory.
"""

import subprocess
import sys
import tempfile

import torch
import torch.distributed as dist

N = 1 << 20


def rank_main(rank: int, rdzv: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank, world_size=2)
    dev = torch.device("cuda", 0)
    t = (torch.arange(N, dtype=torch.float32, device=dev) if rank == 0
         else torch.zeros(N, device=dev))
    if rank == 0:
        dist.send(t, 1)
    else:
        dist.recv(t, 0)
        torch.cuda.synchronize()
        right = torch.equal(t.cpu(), torch.arange(N, dtype=torch.float32))
        print("gloo recv into a CUDA tensor:", "values right" if right else "values wrong")
    dist.destroy_process_group()


def main() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen([sys.executable, __file__, str(r), f"{tmp}/rdzv"],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        for r, p in enumerate(procs):
            try:
                out = p.communicate(timeout=90)[0]
            except subprocess.TimeoutExpired:
                p.kill()
                out = p.communicate()[0] + "\ntimed out"
            print(f"--- rank {r} exit {p.returncode}\n" + "\n".join(out.splitlines()[-8:]))


if __name__ == "__main__":
    if len(sys.argv) == 3:
        rank_main(int(sys.argv[1]), sys.argv[2])
    else:
        main()
