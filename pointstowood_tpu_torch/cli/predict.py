"""Predict CLI of the port: wood/leaf segmentation of point-cloud files
on the GPU (port of pointstowood_tpu/cli/predict.py).

    python -m pointstowood_tpu_torch.cli.predict --point-cloud plot.ply \\
        --model model.pth

Reads each PLY/PCD cloud, tiles it (default dual 2 m / 4 m grid),
classifies every tile, fuses the predictions onto every original point
and writes ``<name>_ours.ply`` next to the input with the input's extra
columns plus ``n_z``, ``label`` and ``pwood``. The flags are the JAX
CLI's (reference: pointstowood/predict.py:61-74); ``--fusion tpu`` keeps
its spelling and means the device fusion paths. Checkpoints are
reference-layout ``.pth`` files (``utils/checkpoint.py``).

Runs on CUDA. ``main(argv, device="cpu")`` runs the plain PyTorch
versions on the CPU instead (for tests); there is no device flag.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import datetime
import os
import os.path as OP
import resource
import time


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--point-cloud', '-p', default=[], nargs='+', type=str,
                        help='list of point cloud files')
    parser.add_argument('--odir', type=str, default='.',
                        help='accepted for parity; outputs are written next '
                             'to each input like the reference (its '
                             'predict.py:124 overwrites odir too)')
    parser.add_argument('--batch_size', default=8, type=int,
                        help='tiles per device batch')
    parser.add_argument('--num_procs', default=-1, type=int,
                        help='number of CPU threads for host-side torch work')
    parser.add_argument('--resolution', type=float, default=0.01,
                        help='accepted for parity; the reference ignores it '
                             '(preprocessing.py:16)')
    parser.add_argument('--grid_size', type=float, nargs='+', default=[2.0, 4.0],
                        help='grid sizes for voxelization')
    parser.add_argument('--min_pts', type=int, default=128,
                        help='minimum number of points in voxel')
    parser.add_argument('--max_pts', type=int, default=16384,
                        help='maximum number of points in voxel')
    parser.add_argument('--model', type=str, default='model.pth',
                        help='path to a reference-layout .pth checkpoint')
    parser.add_argument('--is-wood', default=0.5, type=float,
                        help='probability above which points within KNN are '
                             'classified as wood')
    parser.add_argument('--any-wood', default=1, type=float,
                        help='probability above which ANY point within KNN is '
                             'classified as wood')
    parser.add_argument('--output_fmt', default='ply', help='file type of output')
    parser.add_argument('--vxdir', type=str, default=None,
                        help='optional directory to also write voxel_N.npy tiles')
    parser.add_argument('--channels', type=int, default=32,
                        help='backbone width C (must match the checkpoint)')
    parser.add_argument('--dtype', default='bfloat16',
                        choices=['bfloat16', 'float32'],
                        help='activation compute dtype (bfloat16 = AMP-'
                             'equivalent fast path, float32 = exact)')
    parser.add_argument('--exact_knn', action='store_true',
                        help='plain fp32 neighbor search (parity mode; the '
                             'default runs the CUDA selection kernels)')
    parser.add_argument('--fusion', default='auto',
                        choices=['auto', 'host', 'tpu'],
                        help='fusion neighbor search: on the device '
                             '("tpu", the JAX flag\'s spelling: the pair path, '
                             'else the tile-local index path) or the exact '
                             'host search; auto takes a device path when the '
                             'tiling allows it')
    parser.add_argument('--profile', type=str, default=None,
                        help='write a torch.profiler trace of the model phase '
                             'to this directory')
    parser.add_argument('--verbose', action='store_true', help='print stuff')
    return parser.parse_args(argv)


def resolve_model_path(model: str) -> str:
    if os.path.isfile(model):
        return model
    candidate = os.path.join('model', os.path.basename(model))
    if os.path.isfile(candidate):
        return candidate
    raise FileNotFoundError(f'No model found at {model} or {candidate}')


def main(argv=None, device=None):
    """Run the CLI; returns one record per input file: the output path,
    point count, and per-phase wall seconds (read, preprocess, model,
    fusion_plan, fusion, write). ``device`` defaults to CUDA."""
    start = datetime.datetime.now()
    args = parse_args(argv)

    if args.verbose:
        print('\n---- parameters used ----')
        for k, v in vars(args).items():
            print('{:<35}{}'.format(k, v))

    if not args.point_cloud:
        raise Exception('no input specified, please specify --point-cloud')
    for f in args.point_cloud:
        if not os.path.isfile(f):
            raise FileNotFoundError(f'Point cloud file not found: {f}')

    import torch

    from pointstowood_tpu_torch.config import (
        ModelConfig,
        PredictConfig,
        TilingConfig,
    )
    from pointstowood_tpu_torch.data.tiling import preprocess_cloud
    from pointstowood_tpu_torch.io import load_file, n_rows, save_file
    from pointstowood_tpu_torch.io.loader import canonicalize_columns
    from pointstowood_tpu_torch.predict.predicter import (
        build_net,
        semantic_segmentation,
    )
    from pointstowood_tpu_torch.utils.checkpoint import load_checkpoint
    from pointstowood_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if args.num_procs and args.num_procs > 0:
        torch.set_num_threads(args.num_procs)

    tiling_cfg = TilingConfig(
        grid_size=tuple(args.grid_size), min_pts=args.min_pts,
        max_pts=args.max_pts, resolution=args.resolution,
    )
    model_cfg = ModelConfig(
        channels=args.channels,
        **({'knn_mode': 'exact'} if args.exact_knn else {}),
        compute_dtype=args.dtype,
    )
    predict_cfg = PredictConfig(
        batch_size=args.batch_size, is_wood=args.is_wood,
        any_wood=args.any_wood, output_fmt=args.output_fmt,
        dtype=args.dtype, fusion=args.fusion,
    )
    model_path = resolve_model_path(args.model)
    net = load_checkpoint(model_path, build_net(model_cfg, device=dev))

    def _prep(path_in):
        """Host-side ingest of one plot (read + canonicalize + tiling)."""
        print(f'Voxelising to {list(args.grid_size)} grid sizes')
        t0 = time.perf_counter()
        pc, headers = load_file(path_in, additional_headers=True)
        t1 = time.perf_counter()
        pc, headers, _ = canonicalize_columns(pc, mode='predict')
        tiles = preprocess_cloud(pc, tiling_cfg, with_labels=False,
                                 vxdir=args.vxdir)
        return pc, headers, tiles, {'read': t1 - t0,
                                    'preprocess': time.perf_counter() - t1}

    def _save(out_path, pc, hdrs, record):
        t0 = time.perf_counter()
        save_file(out_path, pc, additional_fields=hdrs, verbose=False)
        record['seconds']['write'] = time.perf_counter() - t0
        print(f'Saved {out_path}')

    # while plot N runs on the device, one worker thread ingests plot N+1
    # and writes plot N-1's output
    records = []
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as ex:
        saves = []
        nxt = ex.submit(_prep, args.point_cloud[0])
        for i, point_cloud_file in enumerate(args.point_cloud):
            out_path = OP.join(
                OP.dirname(point_cloud_file),
                OP.splitext(OP.basename(point_cloud_file))[0] + '_ours.ply')

            if args.verbose:
                print('\n----- Preprocessing started -----')
            pc, headers, tiles, seconds = nxt.result()
            if i + 1 < len(args.point_cloud):
                nxt = ex.submit(_prep, args.point_cloud[i + 1])

            if args.verbose:
                rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
                print(f'peak memory: {rss}')
                print(f'runtime: {(datetime.datetime.now() - start).seconds}')
                print('\n----- Semantic segmentation started -----')

            pc = semantic_segmentation(
                pc, tiles, net, predict_cfg, tiling_cfg,
                verbose=args.verbose, profile_dir=args.profile, device=dev,
                timings=seconds,
            )
            record = {'input': point_cloud_file, 'output': out_path,
                      'points': n_rows(pc), 'tiles': len(tiles),
                      'seconds': seconds}
            records.append(record)
            out_headers = list(dict.fromkeys(headers + ['n_z', 'label',
                                                        'pwood']))
            saves.append(ex.submit(_save, out_path, pc, out_headers, record))

            if args.verbose:
                rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
                print(f'peak memory: {rss}')
                print(f'runtime: {(datetime.datetime.now() - start).seconds}')
        for s in saves:
            s.result()  # surface any writer error with its traceback
    return records


if __name__ == '__main__':
    main()
