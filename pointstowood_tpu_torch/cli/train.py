"""Train CLI of the port: wood/leaf segmentation model training on the GPU
(port of pointstowood_tpu/cli/train.py).

    python -m pointstowood_tpu_torch.cli.train --wdir run --preprocess

The flags are the JAX CLI's (reference: pointstowood/train.py:58-76, plus
--wdir, --channels, --dtype), except that ``--device`` selects the torch
device (default ``cuda``) and ``--model`` names a reference-layout
``.pth`` (default ``model.pth``) or a flax msgpack ``.ckpt``, the JAX
package's format; an existing file of that name is resumed from. Data layout is the reference's: labelled
PLYs under <wdir>/data/train/ and <wdir>/data/test/; --preprocess tiles
them into <wdir>/data/{train,test}/voxels as .npy tiles that later runs
reuse. Outputs: <wdir>/model/<model> (BatchNorm statistics recalibrated
under the eval sampling), the rolling best checkpoints beside it, the
history CSV, and <wdir>/checkpoints/epoch_<n> with --model's suffix.

Data parallelism: launch one process per card with torchrun
(``torchrun --nproc_per_node 4 -m pointstowood_tpu_torch.cli.train ...``)
or with the JAX package's variables (``PTW_COORDINATOR_ADDRESS=host:port
PTW_NUM_PROCESSES=N PTW_PROCESS_ID=i``); every process reads the same
tiles, forwards its rows of each global batch, and ends with the same
model (``parallel/mesh.py``); only process 0 writes the checkpoints, the
history and the backup of old checkpoints.

``main(argv, device=None)``: ``device`` overrides ``--device`` (the tests
pass ``device="cpu"`` to run the plain PyTorch versions). Returns the
history rows.
"""

from __future__ import annotations

import argparse
import datetime
import glob
import os
import resource
import shutil


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--device', type=str, default='cuda',
                        help='torch device to train on')
    parser.add_argument('--num_procs', type=int, default=1)
    parser.add_argument('--num_epochs', default=2, type=int, metavar='N')
    parser.add_argument('--checkpoint_saves', default=1, type=int, metavar='N')
    parser.add_argument('--model', type=str, default='model.pth',
                        help='name of global model [e.g. model.pth, '
                             'model.ckpt]')
    parser.add_argument('--resolution', type=float, default=0.01,
                        help='accepted for parity; ignored like the reference')
    parser.add_argument('--grid_size', type=float, nargs='+', default=[2.0, 4.0])
    parser.add_argument('--min_pts', type=int, default=8192)
    parser.add_argument('--max_pts', type=int, default=16384)
    parser.add_argument('--batch_size', type=int, default=2)
    parser.add_argument('--augmentation', action='store_true')
    parser.add_argument('--preprocess', action='store_true')
    parser.add_argument('--test', action='store_true')
    parser.add_argument('--tune', action='store_true')
    parser.add_argument('--stop_early', action='store_true')
    parser.add_argument('--wandb', action='store_true')
    parser.add_argument('--wdir', type=str, default='.',
                        help='working directory containing data/ and model/')
    parser.add_argument('--arch', default='ptw', choices=['ptw', 'ptv1'],
                        help='network: ptw, the PointsToWood Net; ptv1, '
                             'Point Transformer (pointtransformer_seg50; '
                             '.pth checkpoints only)')
    parser.add_argument('--channels', type=int, default=32,
                        help='backbone width C (reference fixes C=32)')
    parser.add_argument('--dtype', default='bfloat16',
                        choices=['bfloat16', 'float32'],
                        help='activation compute dtype (bfloat16 = AMP-'
                             'equivalent fast path, float32 = exact)')
    parser.add_argument('--verbose', action='store_true')
    args = parser.parse_args(argv)
    if args.arch != 'ptw' and not args.model.endswith(('.pth', '.pt')):
        parser.error(f'--arch {args.arch} takes a .pth or .pt --model')
    return args


def _preprocess(paths, tiling_cfg, vxdir):
    from pointstowood_tpu_torch.data.tiling import preprocess_cloud
    from pointstowood_tpu_torch.io import load_file
    from pointstowood_tpu_torch.io.loader import canonicalize_columns

    for p in paths:
        pc, _ = load_file(p, additional_headers=True, verbose=True)
        pc, _, _ = canonicalize_columns(pc, mode='train')
        print(f'Voxelising to {list(tiling_cfg.grid_size)} grid sizes')
        preprocess_cloud(pc, tiling_cfg, with_labels=True, vxdir=vxdir)


def main(argv=None, device=None):
    start = datetime.datetime.now()
    args = parse_args(argv)
    import numpy as np
    import torch

    from pointstowood_tpu_torch.parallel.mesh import (
        data_group,
        is_primary,
        maybe_init_distributed,
    )
    from pointstowood_tpu_torch.utils.device import resolve_device

    # the process group first (no-op without launch variables); on CUDA it
    # pins this process's card
    dev = resolve_device(args.device if device is None else device)
    maybe_init_distributed(verbose=args.verbose, device=dev)
    group = data_group()

    from pointstowood_tpu_torch.config import (
        ModelConfig,
        TilingConfig,
        TrainConfig,
    )
    from pointstowood_tpu_torch.data.tiling import load_tiles
    from pointstowood_tpu_torch.train.trainer import semantic_training

    if args.num_procs and args.num_procs > 0:
        torch.set_num_threads(args.num_procs)

    print('Mode: train')
    tiling_cfg = TilingConfig(
        grid_size=tuple(args.grid_size), min_pts=args.min_pts,
        max_pts=args.max_pts, resolution=args.resolution,
    )
    train_cfg = TrainConfig(
        num_epochs=args.num_epochs, batch_size=args.batch_size,
        tune=args.tune, augmentation=args.augmentation, test=args.test,
        stop_early=args.stop_early, checkpoint_saves=args.checkpoint_saves,
    )

    checkpoints = np.arange(
        0, args.num_epochs + 1, max(int(args.num_epochs / args.checkpoint_saves), 1)
    )

    # zip + clear old checkpoints (reference train.py:90-94)
    old = [p for suffix in ('pth', 'ckpt') for p in
           glob.glob(os.path.join(args.wdir, f'checkpoints/*.{suffix}'))]
    if old and is_primary(group):
        shutil.make_archive(
            os.path.join(args.wdir, 'checkpoints_backup'), 'zip',
            os.path.join(args.wdir, 'checkpoints'),
        )
        for f in old:
            os.remove(f)

    trfile = os.path.join(args.wdir, 'data', 'train', 'voxels')
    tefile = os.path.join(args.wdir, 'data', 'test', 'voxels')

    if args.preprocess:
        if os.path.exists(trfile):
            shutil.rmtree(trfile)
        if args.verbose:
            print('\n----- Preprocessing started -----')
        clouds = glob.glob(os.path.join(args.wdir, 'data/*/*.ply'))
        _preprocess([w for w in clouds if 'train' in w], tiling_cfg, trfile)
        if args.test:
            if os.path.exists(tefile):
                shutil.rmtree(tefile)
            print('\nTesting')
            _preprocess([w for w in clouds if 'test' in w], tiling_cfg,
                        tefile)
        if args.verbose:
            rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
            print(f'peak memory: {rss}')
            print(f'runtime: {(datetime.datetime.now() - start).seconds}')

    if args.augmentation:
        print('Training with data augmentation performed on 25% of samples')

    train_tiles = load_tiles(trfile)
    if not train_tiles:
        raise FileNotFoundError(
            f'no tiles found in {trfile}; run with --preprocess and labeled '
            f'PLYs under {args.wdir}/data/train/'
        )
    test_tiles = load_tiles(tefile) if args.test else None
    if args.test and not test_tiles:
        test_tiles = None

    if group is not None:
        print(f'Training data-parallel over {group.world_size} processes')
    if args.verbose:
        print('\n----- Semantic segmentation started -----')
    _, history = semantic_training(
        train_tiles, train_cfg,
        ModelConfig(arch=args.arch, channels=args.channels,
                    compute_dtype=args.dtype), tiling_cfg,
        wdir=args.wdir, model_name=args.model, test_tiles=test_tiles,
        checkpoints=checkpoints.tolist(), use_wandb=args.wandb,
        verbose=args.verbose, device=dev, group=group,
    )

    if args.verbose:
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
        print(f'peak memory: {rss}')
        print(f'runtime: {(datetime.datetime.now() - start).seconds}')
    return history


if __name__ == '__main__':
    main()
