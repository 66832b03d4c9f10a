"""Model families (counterpart of ``paddle_tpu/models``): GPT, ERNIE-MoE
and BERT."""
