from paddle_tpu_torch.models.bert import (BertConfig, BertForPretraining,
                                          BertForSequenceClassification,
                                          BertModel)
from paddle_tpu_torch.models.ernie import (ErnieConfig,
                                           ErnieForSequenceClassification,
                                           ErnieModel, ernie_1_0)
from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLM, GPTModel,
                                        gpt2_small, gpt3_13b, gpt3_1p3b,
                                        gpt_moe_1p3b, gpt_moe_tiny, gpt_tiny,
                                        gpt_tiny8)

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM", "gpt_tiny",
           "gpt_tiny8", "gpt_moe_tiny", "gpt_moe_1p3b", "gpt2_small",
           "gpt3_1p3b", "gpt3_13b", "BertConfig",
           "BertModel", "BertForPretraining",
           "BertForSequenceClassification", "ErnieConfig", "ErnieModel",
           "ErnieForSequenceClassification", "ernie_1_0"]
