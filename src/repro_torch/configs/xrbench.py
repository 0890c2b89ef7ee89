"""XR-bench CNN task DAGs, reconstructed from the models the paper cites.

XRBench itself publishes task compositions, not layer tables, so these DAGs
are rebuilt at layer granularity from the cited model papers:

  eye_segmentation   RITNet [4]        — DenseNet-style enc/dec, 640x400,
                                          dense concat skips, tiny channels
                                          -> extreme A/W ratios (Fig. 5/6)
  gaze_estimation    EyeCoD-style [42] — MobileNet-ish conv/dwconv stack
  hand_tracking      HandShape [10]    — ResNet-50-ish encoder, weight heavy
  keyword_spotting   res15 KWS [38]    — 13 convs, 45 ch, residual skips
                                          every 2 layers ("KD-resnet")
  depth_estimation   MiDaS-small [33]  — efficientnet-lite encoder (dwconv)
                                          + RefineNet decoder, long skips
  object_detection   FasterRCNN [34]   — ResNet backbone + RPN + ROIAlign
                                          (complex layer -> pipeline cut)
  action_segmentation TCN [25]         — temporal convs, large channels,
                                          weight heavy
  plane_detection    PlaneRCNN [27]    — deep ResNet-FPN + heads

Absolute MACs differ from the (unpublished) XRBench internals; the A/W span
(~6 orders of magnitude) and skip structure match the paper's Figs. 5-6.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.core.graph import (Graph, Op, OpKind, add, concat, conv,
                                    dwconv, gemm)


def _resnet_stage(ops: List[Op], prefix: str, n_blocks: int, h: int, w: int,
                  cin: int, cmid: int, cout: int, first_stride: int = 1
                  ) -> str:
    """Bottleneck blocks (1x1 -> 3x3 -> 1x1 + skip add)."""
    prev = ops[-1].name
    for b in range(n_blocks):
        stride = first_stride if b == 0 else 1
        cin_b = cin if b == 0 else cout
        p = f"{prefix}_b{b}"
        ops.append(conv(f"{p}_c1", 1, h, w, cin_b, cmid, r=1,
                        stride=stride, inputs=(prev,)))
        ops.append(conv(f"{p}_c2", 1, h, w, cmid, cmid, r=3,
                        inputs=(f"{p}_c1",)))
        ops.append(conv(f"{p}_c3", 1, h, w, cmid, cout, r=1,
                        inputs=(f"{p}_c2",)))
        skip_src = prev
        if b == 0 and (cin != cout or stride != 1):
            ops.append(conv(f"{p}_proj", 1, h, w, cin_b, cout, r=1,
                            stride=stride, inputs=(prev,)))
            skip_src = f"{p}_proj"
        ops.append(add(f"{p}_add", 1, h, w, cout,
                       inputs=(f"{p}_c3", skip_src)))
        prev = f"{p}_add"
    return prev


def eye_segmentation() -> Graph:
    """RITNet: 5 down + 4 up dense blocks, m=32 channels, 640x400 input."""
    ops: List[Op] = [conv("stem", 1, 400, 640, 1, 32, r=3)]
    res = [(400, 640), (200, 320), (100, 160), (50, 80), (25, 40)]

    def dense_block(prefix: str, h: int, w: int, cin: int) -> str:
        names = [ops[-1].name]
        for i in range(4):
            c_in_eff = cin + 32 * i
            src = names[-1] if i == 0 else f"{prefix}_cat{i}"
            if i > 0:
                ops.append(concat(f"{prefix}_cat{i}", 1, h, w, c_in_eff,
                                  inputs=tuple(names)))
                src = f"{prefix}_cat{i}"
            ops.append(conv(f"{prefix}_c{i}", 1, h, w, c_in_eff, 32, r=3,
                            inputs=(src,)))
            names.append(f"{prefix}_c{i}")
        return names[-1]

    prev = "stem"
    for d, (h, w) in enumerate(res):
        if d > 0:
            ops.append(Op(f"down{d}", OpKind.POOL,
                          dict(N=1, H=h, W=w, C=32), inputs=(prev,), stride=2))
        prev = dense_block(f"db{d}", h, w, 32)
    for u, (h, w) in enumerate(reversed(res[:-1])):
        ops.append(Op(f"up{u}", OpKind.UPSAMPLE, dict(N=1, H=h, W=w, C=32),
                      inputs=(prev,), stride=2))
        # skip concat from the same-resolution down block
        ops.append(concat(f"ub{u}_cat", 1, h, w, 64,
                          inputs=(f"up{u}", f"db{3 - u}_c3")))
        prev = dense_block(f"ub{u}", h, w, 64)
    ops.append(conv("head", 1, 400, 640, 32, 4, r=1, inputs=(prev,)))
    return Graph("eye_segmentation", ops)


def gaze_estimation() -> Graph:
    """EyeCoD-style MobileNet gaze net on 128x128 eye crops."""
    ops: List[Op] = [conv("stem", 1, 64, 64, 3, 16, r=3, stride=2)]
    cfg = [  # (h, w, cin, cout)
        (64, 64, 16, 24), (32, 32, 24, 32), (32, 32, 32, 32),
        (16, 16, 32, 64), (16, 16, 64, 64), (8, 8, 64, 128),
        (8, 8, 128, 128),
    ]
    prev = "stem"
    for i, (h, w, ci, co) in enumerate(cfg):
        ops.append(dwconv(f"dw{i}", 1, h, w, ci, r=3,
                          stride=1 if ci == co else 2, inputs=(prev,)))
        ops.append(conv(f"pw{i}", 1, h, w, ci, co, r=1, inputs=(f"dw{i}",)))
        prev = f"pw{i}"
    ops.append(Op("gap", OpKind.GLOBALPOOL, dict(N=1, H=8, W=8, C=128),
                  inputs=(prev,)))
    ops.append(gemm("fc1", 1, 128, 128, inputs=("gap",)))
    ops.append(gemm("fc2", 1, 3, 128, inputs=("fc1",)))
    return Graph("gaze_estimation", ops)


def hand_tracking() -> Graph:
    """HandShape: ResNet-50-ish encoder on 256x256 + pose GEMM heads."""
    ops: List[Op] = [conv("stem", 1, 128, 128, 3, 64, r=7, stride=2)]
    prev = _resnet_stage(ops, "s1", 3, 64, 64, 64, 64, 256)
    prev = _resnet_stage(ops, "s2", 4, 32, 32, 256, 128, 512, 2)
    prev = _resnet_stage(ops, "s3", 6, 16, 16, 512, 256, 1024, 2)
    prev = _resnet_stage(ops, "s4", 3, 8, 8, 1024, 512, 2048, 2)
    ops.append(Op("gap", OpKind.GLOBALPOOL, dict(N=1, H=8, W=8, C=2048),
                  inputs=(prev,)))
    ops.append(gemm("fc_pose", 1, 1024, 2048, inputs=("gap",)))
    ops.append(gemm("fc_shape", 1, 63, 1024, inputs=("fc_pose",)))
    return Graph("hand_tracking", ops)


def keyword_spotting() -> Graph:
    """res15 KWS ("KD-resnet"): 13 convs, 45 channels, 101x40 MFCC input,
    residual adds every two convs."""
    ops: List[Op] = [conv("c0", 1, 101, 40, 1, 45, r=3)]
    prev = "c0"
    for b in range(6):
        ops.append(conv(f"b{b}_c1", 1, 101, 40, 45, 45, r=3, inputs=(prev,)))
        ops.append(conv(f"b{b}_c2", 1, 101, 40, 45, 45, r=3,
                        inputs=(f"b{b}_c1",)))
        ops.append(add(f"b{b}_add", 1, 101, 40, 45,
                       inputs=(f"b{b}_c2", prev)))
        prev = f"b{b}_add"
    ops.append(Op("gap", OpKind.GLOBALPOOL, dict(N=1, H=101, W=40, C=45),
                  inputs=(prev,)))
    ops.append(gemm("fc", 1, 12, 45, inputs=("gap",)))
    return Graph("keyword_spotting", ops)


def depth_estimation() -> Graph:
    """MiDaS-small: efficientnet-lite encoder (dwconv-heavy) + RefineNet
    decoder consuming one long-distance skip per encoder stage."""
    ops: List[Op] = [conv("stem", 1, 128, 160, 3, 32, r=3, stride=2)]
    enc_taps: List[str] = []
    cfg = [(128, 160, 32, 24, 2), (64, 80, 24, 40, 2), (32, 40, 40, 112, 3),
           (16, 20, 112, 320, 3)]
    prev = "stem"
    for s, (h, w, ci, co, reps) in enumerate(cfg):
        for rblk in range(reps):
            cin_b = ci if rblk == 0 else co
            ops.append(conv(f"e{s}_{rblk}_exp", 1, h, w, cin_b, cin_b * 6,
                            r=1, inputs=(prev,)))
            ops.append(dwconv(f"e{s}_{rblk}_dw", 1, h, w, cin_b * 6, r=3,
                              stride=2 if rblk == 0 else 1,
                              inputs=(f"e{s}_{rblk}_exp",)))
            ops.append(conv(f"e{s}_{rblk}_pw", 1, h, w, cin_b * 6, co, r=1,
                            inputs=(f"e{s}_{rblk}_dw",)))
            if rblk > 0:
                ops.append(add(f"e{s}_{rblk}_add", 1, h, w, co,
                               inputs=(f"e{s}_{rblk}_pw", prev)))
                prev = f"e{s}_{rblk}_add"
            else:
                prev = f"e{s}_{rblk}_pw"
        enc_taps.append(prev)
    # decoder: fuse taps from deep to shallow (long reuse distances)
    dec_cfg = [(16, 20, 320), (32, 40, 112), (64, 80, 40), (128, 160, 24)]
    for d, (h, w, c_tap) in enumerate(dec_cfg):
        tap = enc_taps[len(enc_taps) - 1 - d]
        if d == 0:
            ops.append(conv(f"d{d}_fuse", 1, h, w, c_tap, 64, r=3,
                            inputs=(tap,)))
        else:
            ops.append(Op(f"d{d}_up", OpKind.UPSAMPLE,
                          dict(N=1, H=h, W=w, C=64),
                          inputs=(f"d{d-1}_out",), stride=2))
            ops.append(conv(f"d{d}_lat", 1, h, w, c_tap, 64, r=1,
                            inputs=(tap,)))
            ops.append(add(f"d{d}_add", 1, h, w, 64,
                           inputs=(f"d{d}_up", f"d{d}_lat")))
            ops.append(conv(f"d{d}_fuse", 1, h, w, 64, 64, r=3,
                            inputs=(f"d{d}_add",)))
        ops.append(conv(f"d{d}_out", 1, h, w, 64, 64, r=3,
                        inputs=(f"d{d}_fuse",)))
    ops.append(conv("head", 1, 128, 160, 64, 1, r=3, inputs=("d3_out",)))
    return Graph("depth_estimation", ops)


def object_detection() -> Graph:
    """FasterRCNN-lite: ResNet backbone + RPN + ROIAlign + GEMM heads."""
    ops: List[Op] = [conv("stem", 1, 200, 320, 3, 64, r=7, stride=2)]
    prev = _resnet_stage(ops, "s1", 2, 100, 160, 64, 64, 256, 2)
    prev = _resnet_stage(ops, "s2", 2, 50, 80, 256, 128, 512, 2)
    prev = _resnet_stage(ops, "s3", 2, 25, 40, 512, 256, 1024, 2)
    ops.append(conv("rpn_conv", 1, 25, 40, 1024, 256, r=3, inputs=(prev,)))
    ops.append(conv("rpn_cls", 1, 25, 40, 256, 18, r=1, inputs=("rpn_conv",)))
    ops.append(Op("roialign", OpKind.ROIALIGN,
                  dict(N=100, H=7, W=7, C=1024), inputs=(prev,)))
    ops.append(gemm("head_fc1", 100, 1024, 1024 * 7 * 7,
                    inputs=("roialign",)))
    ops.append(gemm("head_fc2", 100, 1024, 1024, inputs=("head_fc1",)))
    ops.append(gemm("head_cls", 100, 81, 1024, inputs=("head_fc2",)))
    return Graph("object_detection", ops)


def action_segmentation() -> Graph:
    """TCN: dilated temporal convs over T=128 frames of 2048-d features;
    large channels, small activations -> weight heavy (paper Sec. VI-A)."""
    ops: List[Op] = [gemm("proj", 128, 1024, 2048)]
    prev = "proj"
    for layer in range(10):
        # 1-D conv as GEMM over time: kernel size 3 -> K = 3*1024
        ops.append(gemm(f"tcn{layer}", 128, 1024, 3 * 1024, inputs=(prev,)))
        if layer % 2 == 1:
            ops.append(Op(f"tcn{layer}_add", OpKind.ADD,
                          dict(N=1, H=128, W=1, C=1024),
                          inputs=(f"tcn{layer}", prev)))
            prev = f"tcn{layer}_add"
        else:
            prev = f"tcn{layer}"
    ops.append(gemm("cls", 128, 48, 1024, inputs=(prev,)))
    return Graph("action_segmentation", ops)


def plane_detection() -> Graph:
    """PlaneRCNN-lite: deeper ResNet-FPN + mask head."""
    ops: List[Op] = [conv("stem", 1, 120, 160, 3, 64, r=7, stride=2)]
    prev = _resnet_stage(ops, "s1", 3, 120, 160, 64, 64, 256)
    prev = _resnet_stage(ops, "s2", 4, 60, 80, 256, 128, 512, 2)
    prev = _resnet_stage(ops, "s3", 6, 30, 40, 512, 256, 1024, 2)
    ops.append(conv("fpn_lat", 1, 30, 40, 1024, 256, r=1, inputs=(prev,)))
    ops.append(conv("fpn_out", 1, 30, 40, 256, 256, r=3, inputs=("fpn_lat",)))
    ops.append(Op("roialign", OpKind.ROIALIGN,
                  dict(N=50, H=14, W=14, C=256), inputs=("fpn_out",)))
    for i in range(4):
        src = "roialign" if i == 0 else f"mask{i-1}"
        ops.append(conv(f"mask{i}", 50, 14, 14, 256, 256, r=3, inputs=(src,)))
    ops.append(conv("mask_out", 50, 28, 28, 256, 1, r=1, inputs=("mask3",)))
    return Graph("plane_detection", ops)


TASKS: Dict[str, "function"] = {
    "eye_segmentation": eye_segmentation,
    "gaze_estimation": gaze_estimation,
    "hand_tracking": hand_tracking,
    "keyword_spotting": keyword_spotting,
    "depth_estimation": depth_estimation,
    "object_detection": object_detection,
    "action_segmentation": action_segmentation,
    "plane_detection": plane_detection,
}


def all_tasks() -> Dict[str, Graph]:
    return {name: fn() for name, fn in TASKS.items()}
