"""Which collectives and wrappers the ``gloo`` backend carries on CUDA
tensors, with two processes sharing one card.

    python3 probe_gloo_collectives.py

NCCL refuses two ranks on one device, so where processes share a card
(``parallel/mesh.py`` picks ``gloo`` there) this is what they can use. Each
check runs in its own pair of processes, so one that crashes is named and
the rest still run. Prints one line a check (OK or FAILED with the exit
codes) and its per-rank results, and exits 0 whatever the checks gave.
"""

from __future__ import annotations

import datetime
import json
import socket
import subprocess
import sys

import torch
import torch.distributed as dist

CHECKS = ('all_reduce', 'all_gather', 'all_gather_into_tensor', 'reduce_scatter_tensor',
          'all_gather_object', 'mesh2d_subgroups', 'ddp', 'fsdp_1d', 'fsdp_2d')


def _small_model(dev: torch.device) -> torch.nn.Module:
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Linear(16, 4)).to(dev)


def run(check: str, rank: int, port: int) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group('gloo', init_method=f'tcp://localhost:{port}', rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=60))
    dev = torch.device('cuda', 0)
    x = torch.ones(4, device=dev) * (rank + 1)
    if check == 'all_reduce':
        dist.all_reduce(x)
        out = x.tolist()
    elif check == 'all_gather':
        parts = [torch.empty(4, device=dev) for _ in range(2)]
        dist.all_gather(parts, x)
        out = [t.tolist() for t in parts]
    elif check == 'all_gather_into_tensor':
        whole = torch.empty(8, device=dev)
        dist.all_gather_into_tensor(whole, x)
        out = whole.tolist()
    elif check == 'reduce_scatter_tensor':
        part = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(part, torch.arange(4.0, device=dev))
        out = part.tolist()
    elif check == 'all_gather_object':
        objs = [None, None]
        dist.all_gather_object(objs, {'rank': rank})
        out = objs
    else:
        from torch.distributed.device_mesh import init_device_mesh

        if check == 'mesh2d_subgroups':
            mesh = init_device_mesh('cuda', (1, 2), mesh_dim_names=('data', 'model'))
            dist.all_reduce(x, group=mesh.get_group('model'))
            out = x.tolist()
        elif check == 'ddp':
            model = _small_model(dev)
            ddp = torch.nn.parallel.DistributedDataParallel(model, device_ids=[dev])
            with ddp.no_sync():
                ddp(torch.randn(3, 8, device=dev)).sum().backward()
            ddp(torch.randn(3, 8, device=dev)).sum().backward()
            out = float(model[0].weight.grad.sum())
        else:
            from torch.distributed.fsdp import fully_shard

            mesh = (init_device_mesh('cuda', (2,)) if check == 'fsdp_1d' else
                    init_device_mesh('cuda', (1, 2), mesh_dim_names=('data', 'model')))
            model = fully_shard(_small_model(dev), mesh=mesh)
            print('sharded', flush=True)
            model(torch.randn(3, 8, device=dev)).sum().backward()
            print('backward', flush=True)
            out = float(model[0].weight.grad.full_tensor().sum())
    dist.barrier()
    dist.destroy_process_group()
    print(json.dumps({'check': check, 'rank': rank, 'out': out}), flush=True)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        return sock.getsockname()[1]


def main() -> None:
    print(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
          f'{torch.cuda.device_count()} card(s)', flush=True)
    for check in CHECKS:
        port = _free_port()
        procs = [subprocess.Popen([sys.executable, __file__, check, str(rank), str(port)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for rank in range(2)]
        outputs = []
        for proc in procs:
            try:
                outputs.append(proc.communicate(timeout=90)[0])
            except subprocess.TimeoutExpired:
                proc.kill()
                outputs.append(proc.communicate()[0] + '\nTIMEOUT')
        codes = [proc.returncode for proc in procs]
        print(f'{check}: {"OK" if codes == [0, 0] else "FAILED"}, exit codes {codes}',
              flush=True)
        for text in outputs:
            for line in text.splitlines():
                if line.startswith('{') or line in ('sharded', 'backward') or 'Error' in line:
                    print(f'  {line}', flush=True)


if __name__ == '__main__':
    if len(sys.argv) == 4:
        run(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
    else:
        main()
