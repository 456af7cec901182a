// Blockwise (flash) attention with a key mask:
//     out = softmax(Q K^T / sqrt(dh) masked by the key mask) V   per head.
//
//   flash_attention_fwd  replaces imcui_tpu/ops/attention.py:_flash_pallas
//                        (kernel _flash_attn_kernel), the route LightGlue's
//                        self-attention takes above 2048 keypoints, and
//                        mha_auto's beyond K3 and K14. This file holds only
//                        the entry point: float32 inputs go to the register
//                        tile of attention.cu (flash_attention_f32), bf16
//                        inputs to the TMA and wgmma body of
//                        qtiled_attention.cu (flash_attention_bf16).
//
// The contract, read off the Pallas kernel: Nq and Nk are independent; the
// head dim is 64 or 128; inputs are f32 or bf16, the arithmetic f32 and the
// output in the input type; the running max starts at the finite -1e9 and
// masked logits are -1e9, so a query whose keys are all masked gets the
// mean of V; keys past Nk weigh 0; the denominator is max(l, 1e-20). The
// two bodies keep it as follows:
//
// - float32: attention.cu's tile starts m at -inf, which gives the same
//   result (its note says why). Its sums cannot fall below 1, so the
//   denominator's floor never binds.
// - bf16: m starts at the floor -1e9 log2(e) in base 2, and a masked key's
//   scaled logit is that floor exactly, not a raw logit of -1e9 scaled by
//   1/sqrt(dh), so all-masked rows return the mean of V. The Pallas body
//   keeps p in f32; the tensor cores take bf16, so P goes in as a bf16
//   high part and a bf16 low part (P - high), two products into one f32
//   accumulator: about 2^-17 of each weight, against 2^-9 for P rounded
//   once, which misses 2^-7 of an output near 0 whose products cancel.
//
// What bounds it on an H100: operations, 4 Nq Nk dh flop per head-sequence
// (34.4 GFLOP for the 8 head-sequences of one pair at 4096 keypoints: 0.51
// ms at 67 TFLOP/s f32, 0.035 ms at 989 TFLOP/s bf16; 0.052 with the
// second P V), far above its bytes. float32 has no tensor-core route
// without TF32, so its design keeps the FMA units fed from registers
// (K3 and K4's tile); bf16 is K14's design, where the softmax's
// exponentials take as long as the products.

#include <cuda_runtime.h>

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   const void* mask, void* out, int BH, int Nq,
                                   int Nk, int heads, int dh, void* stream);
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, const void* mask,
                                    void* out, int BH, int Nq, int Nk,
                                    int heads, int dh, void* stream);
extern "C" int flash_attention_f32_plan(int BH, int Nq, int dh, void* out);
extern "C" int flash_attention_bf16_plan(int BH, int Nq, int dh, void* out);

// q, out: (BH, Nq, dh); k, v: (BH, Nk, dh); mask: (BH / heads, Nk) bytes,
// or null for every key valid. dh is 64 or 128; bf16 != 0 selects
// __nv_bfloat16 tensors, else float.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* mask, void* out, int BH, int Nq,
                                   int Nk, int heads, int dh, int bf16,
                                   void* stream) {
  if (Nk < 1 && BH > 0 && Nq > 0 && (dh == 64 || dh == 128))  // no keys
    return static_cast<int>(cudaMemsetAsync(
        out, 0, size_t(BH) * Nq * dh * (bf16 ? 2 : 4),
        static_cast<cudaStream_t>(stream)));
  return bf16 ? flash_attention_bf16(q, k, v, mask, out, BH, Nq, Nk, heads,
                                     dh, stream)
              : flash_attention_f32(q, k, v, mask, out, BH, Nq, Nk, heads,
                                    dh, stream);
}

// The launch plan at this shape, for the records: out[0..3] = query rows a
// block, blocks, blocks an SM holds, SMs on the card.
extern "C" int flash_attention_plan(int BH, int Nq, int dh, int bf16,
                                    void* out) {
  return bf16 ? flash_attention_bf16_plan(BH, Nq, dh, out)
              : flash_attention_f32_plan(BH, Nq, dh, out);
}
