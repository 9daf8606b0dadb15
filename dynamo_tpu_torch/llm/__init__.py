"""The OpenAI front's LLM stages: the tokenizer, the model card, the
preprocessor, the detokenizing backend and tool-call parsing (the port's
copies of ``dynamo_tpu/llm``)."""
