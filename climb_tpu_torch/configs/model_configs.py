"""Model registry (the port's copy of the ViLT entries of
``climb_tpu/configs/model_configs.py``, same keys and values). The ViLT-BERT
entries come with that encoder's slice."""

vilt_config = {
    "encoder_dim": 768,
    "visual_input_type": "pil-image",
    "encoder_class": "vilt",
    "batch2inputs_converter": "vilt_single",
    "encoder_name": "ViLT",
}

vilt_lang_seq_config = {
    "encoder_dim": 768,
    "visual_input_type": "pil-image",
    "encoder_class": "vilt",
    "classifier_class": "vilt_seq_classification",
    "batch2inputs_converter": "vilt_seq",
}

vilt_lang_mc_config = {
    "encoder_dim": 768,
    "visual_input_type": "pil-image",
    "encoder_class": "vilt",
    "classifier_class": "vilt_multiple_choice",
    "batch2inputs_converter": "vilt_mc",
}

vilt_vision_cls_config = {
    "encoder_dim": 768,
    "visual_input_type": "pil-image",
    "encoder_class": "vilt",
    "classifier_class": "vilt_image_classification",
    "batch2inputs_converter": "vilt_single",
}

model_configs = {
    "vilt": vilt_config,
    "vilt-v-cls": vilt_vision_cls_config,
    "vilt-l-seq": vilt_lang_seq_config,
    "vilt-l-mc": vilt_lang_mc_config,
}
