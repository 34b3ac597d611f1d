"""The weight images the hand-written `wgmma` kernels read as their B
operand, and the plain PyTorch products their plain versions and their
emulations take. K1 and K2 (points_mlp), K3 (sigma_color) and K4
(fused_mlp) share them.

* bf16: `wgmma_b`, a layer as wgmma's B image (csrc/sm90.cuh b_desc), and
  `dot`, the plain chains' product (the compute dtype's operands, f32 sums);
* float32: the f32 kernels run on the tensor cores as 3xTF32 (csrc/sm90.cuh
  tf32_group): every operand split into two tf32 values (`tf32_split`),
  each product summed in f32 as lo W_hi + hi W_lo + hi W_hi (`tf32_dot`).
  Their weights come as hi and lo tf32 B images, each 8-deep k-step's rows
  in K_ORDER (`wgmma_b_tf32`), cut into the chunks a kernel streams
  (`tf32_chunks`).
"""

import torch

# the order of an 8-deep k-step's rows in the f32 images: A column t4 of
# thread t4's tf32 fragment is column 2 t4 of its accumulator, A column
# t4 + 4 column 2 t4 + 1 (csrc/sm90.cuh, acc_to_v)
K_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def dot(h, w, dtype):
    """bf16 (or f32) operands, f32 sum: JAX's preferred_element_type=f32."""
    return torch.matmul(h.to(dtype).float(), w.to(dtype).float())


def wgmma_b(w):
    """w [K, N] (K a multiple of 16, N of 8) as wgmma's B operand image,
    flat: for each 16-deep k-step, the column groups of 8 (256 bytes
    apart), each two 8 x 8 core matrices (depths 0-7 and 8-15, 128 bytes
    apart) of 8 columns x 8 depths, column n of the group at 16 n bytes and
    depth k at 2 k bytes."""
    k, n = w.shape
    return w.reshape(k // 16, 2, 8, n // 8, 8).permute(0, 3, 1, 4, 2) \
        .reshape(-1)


def tf32_round(x):
    """x (f32) rounded to tf32 as `cvt.rna.tf32.f32` rounds it: to the
    nearest value with 10 mantissa bits, ties away from zero; the f32 bit
    pattern with its 13 low bits zero. Finite inputs."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(x):
    """(hi, lo): hi = tf32(x), lo = tf32(x - hi), so that hi + lo keeps
    about 21 bits of x's 24."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def wgmma_b_tf32(w):
    """w [K, N] f32 (K and N multiples of 8) as the f32 kernel's B image,
    flat: for each 8-deep k-step, its rows taken in K_ORDER, the column
    groups of 8 (256 bytes apart), each two 8 x 4 core matrices (depths 0-3
    and 4-7, 128 bytes apart) of 8 columns x 4 depths, column n of the group
    at 16 n bytes and depth k at 4 k bytes."""
    k, n = w.shape
    w = w.reshape(k // 8, 8, n)[:, list(K_ORDER)]
    return w.reshape(k // 8, 2, 4, n // 8, 8).permute(0, 3, 1, 4, 2) \
        .reshape(-1)


def tf32_chunks(w, kch=None, parts=1):
    """w [K, N] f32 as the f32 kernels read it (csrc/sm90.cuh): in `parts`
    parts of N / parts columns, each cut into chunks of `kch` 8-deep
    k-steps (all K / 8 of them by default), each chunk its hi image and
    then its lo image (`tf32_split`, `wgmma_b_tf32`): a list of flat
    images in that order. K must be a multiple of 8 kch, N / parts of 8."""
    k, n = w.shape
    kch = kch or k // 8
    out = []
    for p in range(parts):
        hi, lo = tf32_split(w[:, p * n // parts:(p + 1) * n // parts])
        for r in range(0, k, 8 * kch):
            out += [wgmma_b_tf32(hi[r:r + 8 * kch]),
                    wgmma_b_tf32(lo[r:r + 8 * kch])]
    return out


def tf32_dot(a, w, products=3):
    """a @ w as the f32 kernels compute it: both operands split into tf32
    values (`tf32_split`) and summed in f32 as lo @ W_hi + hi @ W_lo +
    hi @ W_hi (products=3). Fewer products are what the kernels do not do:
    2 leaves lo @ W_hi out, 1 is the single tf32 product hi @ W_hi."""
    (ah, al), (wh, wl) = tf32_split(a), tf32_split(w)
    if products == 1:
        return ah @ wh
    if products == 2:
        return ah @ wl + ah @ wh
    return al @ wh + ah @ wl + ah @ wh
