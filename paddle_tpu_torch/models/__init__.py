from paddle_tpu_torch.models.bert import (BertConfig, BertForPretraining,
                                          BertForPretrainingPipe,
                                          BertForSequenceClassification,
                                          BertModel)
from paddle_tpu_torch.models.ernie import (ErnieConfig,
                                           ErnieForPretrainingPipe,
                                           ErnieForSequenceClassification,
                                           ErnieModel, ernie_1_0)
from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLM,
                                        GPTForCausalLMPipe, GPTModel,
                                        gpt2_small, gpt3_13b, gpt3_1p3b,
                                        gpt_moe_1p3b, gpt_moe_tiny, gpt_tiny,
                                        gpt_tiny8)

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "GPTForCausalLMPipe",
           "gpt_tiny", "gpt_tiny8", "gpt_moe_tiny", "gpt_moe_1p3b",
           "gpt2_small", "gpt3_1p3b", "gpt3_13b", "BertConfig",
           "BertModel", "BertForPretraining", "BertForPretrainingPipe",
           "BertForSequenceClassification", "ErnieConfig", "ErnieModel",
           "ErnieForPretrainingPipe", "ErnieForSequenceClassification",
           "ernie_1_0"]
