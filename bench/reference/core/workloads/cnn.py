"""CNN-family workloads: ResNet-50 (INT8) and SNN-VGG9 (paper Table 1)."""
from __future__ import annotations

from ..ir import OpNode, OpType, Precision, WorkloadGraph

__all__ = ["resnet50", "snn_vgg9"]

# (blocks, mid_channels, out_channels, spatial) per ResNet-50 stage
_R50_STAGES = (
    (3, 64, 256, 56),
    (4, 128, 512, 28),
    (6, 256, 1024, 14),
    (3, 512, 2048, 7),
)


def _conv(g, name, hw, cin, cout, k, preds, sparsity=0.5, stride=1,
          prec=Precision.INT8):
    out_hw = hw // stride
    i = g.add(OpNode(name, OpType.CONV2D, m=out_hw * out_hw, k=cin * k * k,
                     n=cout, precision=prec, act_sparsity=sparsity), preds)
    return i


def resnet50() -> WorkloadGraph:
    """ResNet-50, INT8 post-training quantized (the paper's headline
    per-workload DSE winner, +60.10 %).  BN folds into the convolutions at
    inference; residual adds and ReLUs are explicit DSP ops."""
    g = WorkloadGraph("resnet50_int8", model_precision=Precision.INT8,
                      family="cnn")
    c = _conv(g, "conv1", 224, 3, 64, 7, (), sparsity=0.0, stride=2)
    r = g.dsp("relu1", OpType.RELU, elems=112 * 112 * 64, preds=[c])
    p = g.dsp("maxpool", OpType.POOL, elems=56 * 56 * 64, preds=[r])
    x, cin = p, 64
    for s, (blocks, mid, cout, hw) in enumerate(_R50_STAGES):
        for b in range(blocks):
            stride = 2 if (b == 0 and s > 0) else 1
            pre = f"s{s}b{b}"
            c1 = _conv(g, f"{pre}_conv1", hw * stride, cin, mid, 1, [x],
                       stride=stride)
            r1 = g.dsp(f"{pre}_relu1", OpType.RELU, elems=hw * hw * mid, preds=[c1])
            c2 = _conv(g, f"{pre}_conv2", hw, mid, mid, 3, [r1])
            r2 = g.dsp(f"{pre}_relu2", OpType.RELU, elems=hw * hw * mid, preds=[c2])
            c3 = _conv(g, f"{pre}_conv3", hw, mid, cout, 1, [r2])
            if b == 0:
                sc = _conv(g, f"{pre}_downsample", hw * stride, cin, cout, 1,
                           [x], stride=stride)
                a = g.dsp(f"{pre}_add", OpType.ADD, elems=hw * hw * cout,
                          preds=[c3, sc])
            else:
                a = g.dsp(f"{pre}_add", OpType.ADD, elems=hw * hw * cout,
                          preds=[c3, x])
            x = g.dsp(f"{pre}_relu3", OpType.RELU, elems=hw * hw * cout, preds=[a])
            cin = cout
    gp = g.dsp("avgpool", OpType.POOL, elems=7 * 7 * 2048, preds=[x])
    fc = g.add(OpNode("classifier_fc", OpType.FC, m=1, k=2048, n=1000,
                      precision=Precision.INT8), [gp])
    g.dsp("softmax", OpType.SOFTMAX, elems=1000, preds=[fc])
    return g


_VGG9 = (  # (cin, cout, hw) conv stack for the SNN-VGG9 of the SNN literature
    (3, 64, 32), (64, 64, 32),
    (64, 128, 16), (128, 128, 16),
    (128, 256, 8), (256, 256, 8), (256, 256, 8),
)


def snn_vgg9(timesteps: int = 4) -> WorkloadGraph:
    """Spiking VGG9: each conv integrates over T timesteps and feeds a
    leaky-integrate-and-fire (LIF) layer.  ~47 % of wall time is LIF
    integration on commercial NPUs (paper Fig. 3); spike trains are highly
    sparse (~90 % zeros) which two-sided-sparsity tiles exploit."""
    g = WorkloadGraph("snn_vgg9", model_precision=Precision.FP16, family="snn")
    x = None
    for li, (cin, cout, hw) in enumerate(_VGG9):
        preds = [x] if x is not None else ()
        c = g.add(OpNode(f"conv{li}", OpType.CONV2D, m=timesteps * hw * hw,
                         k=cin * 9, n=cout, precision=Precision.FP16,
                         act_sparsity=0.0 if li == 0 else 0.9), preds)
        x = g.add(OpNode(f"lif{li}", OpType.SNN_LIF, elems=hw * hw * cout,
                         snn_timesteps=timesteps, precision=Precision.FP16), [c])
    fc1 = g.add(OpNode("fc1", OpType.FC, m=timesteps, k=256 * 4 * 4, n=1024,
                       precision=Precision.FP16, act_sparsity=0.9), [x])
    l1 = g.add(OpNode("lif_fc1", OpType.SNN_LIF, elems=1024,
                      snn_timesteps=timesteps, precision=Precision.FP16), [fc1])
    fc2 = g.add(OpNode("classifier", OpType.FC, m=timesteps, k=1024, n=10,
                       precision=Precision.FP16, act_sparsity=0.9), [l1])
    g.dsp("rate_decode", OpType.REDUCE, elems=timesteps * 10, preds=[fc2])
    return g
