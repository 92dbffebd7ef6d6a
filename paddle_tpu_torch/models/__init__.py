from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLM, GPTModel,
                                        gpt2_small, gpt_tiny)

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "gpt_tiny",
           "gpt2_small"]
