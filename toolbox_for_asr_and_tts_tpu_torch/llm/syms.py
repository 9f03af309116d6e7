"""Built-in medical-symptom hotword list (SYMS).

Copy of `toolbox_for_asr_and_tts_tpu/llm/syms.py` for the port
(framework-free; imports kept relative).

Equivalent of the reference's hard-coded symptom vocabulary
(voice-service/app/services/full_hotwords.py:2-291), which seeds LLM
correction when no hotwords file is deployed. This is an independent,
de-duplicated list covering the same clinical domains (the reference's list
contains known missing-comma concatenation bugs, survey §2.1 V9; this one is
clean). Deployments override it with hotwords.txt.
"""

SYMS = [
    # general
    "发热", "发烧", "寒战", "乏力", "疲劳", "消瘦", "体重下降", "盗汗",
    "食欲不振", "食欲减退", "水肿", "浮肿", "头晕", "头痛", "眩晕", "晕厥",
    # respiratory
    "咳嗽", "咳痰", "咯血", "气短", "气促", "胸闷", "胸痛", "呼吸困难",
    "喘息", "气喘", "打鼾", "咽痛", "咽干", "声音嘶哑", "流涕", "鼻塞",
    "打喷嚏", "黄痰", "白痰", "粘痰",
    # cardiovascular
    "心悸", "心慌", "心前区疼痛", "心律不齐", "心动过速", "心动过缓",
    "高血压", "低血压", "心衰", "心力衰竭", "冠心病", "心绞痛", "心肌梗死",
    "房颤", "早搏", "下肢水肿",
    # digestive
    "腹痛", "腹胀", "腹泻", "便秘", "恶心", "呕吐", "反酸", "烧心",
    "嗳气", "呃逆", "吞咽困难", "黑便", "便血", "呕血", "黄疸",
    "肝区疼痛", "胃痛", "胃胀", "消化不良", "里急后重",
    # neurological
    "偏头痛", "麻木", "肢体麻木", "震颤", "抽搐", "惊厥", "意识障碍",
    "言语不清", "口齿不清", "记忆力减退", "失眠", "嗜睡", "多梦",
    "耳鸣", "耳聋", "视物模糊", "复视", "偏瘫", "面瘫",
    # musculoskeletal
    "关节痛", "关节肿胀", "肌肉酸痛", "腰痛", "腰酸", "背痛", "颈肩痛",
    "骨折", "扭伤", "活动受限", "晨僵",
    # urinary / metabolic
    "尿频", "尿急", "尿痛", "血尿", "尿失禁", "排尿困难", "夜尿增多",
    "少尿", "无尿", "蛋白尿", "糖尿病", "高血糖", "低血糖", "高血脂",
    "高尿酸", "痛风",
    # skin
    "皮疹", "瘙痒", "荨麻疹", "紫癜", "淤斑", "脱发", "多汗",
    # gynecological / others
    "痛经", "月经不调", "阴道出血", "白带异常",
    # psychiatric
    "焦虑", "抑郁", "烦躁", "情绪低落", "紧张",
    # additional clinical vocabulary (domains in the reference's SYMS list)
    "胸骨后疼痛", "放射痛", "绞痛", "钝痛", "刺痛", "隐痛", "压痛",
    "反跳痛", "游走性疼痛", "夜间痛", "活动后加重", "休息后缓解",
    "咽部异物感", "吞咽疼痛", "口干", "口苦", "口臭", "味觉减退",
    "鼻出血", "流脓涕", "嗅觉减退", "视力下降", "畏光", "流泪",
    "眼痛", "眼红", "听力下降", "耳痛", "耳流脓",
    "心悸气短", "端坐呼吸", "夜间阵发性呼吸困难", "下肢无力",
    "间歇性跛行", "肌肉萎缩", "肢体抽动", "步态不稳",
    "大便带血", "大便变细", "排便习惯改变", "肛门坠胀",
    "尿量减少", "泡沫尿", "腰背酸痛", "会阴部疼痛",
    "月经量多", "月经量少", "闭经", "不孕", "乳房胀痛", "乳头溢液",
    "体重增加", "怕冷", "怕热", "多饮", "多食", "易饥",
    "皮肤干燥", "皮肤变黄", "色素沉着", "毛发脱落", "指甲改变",
    "淋巴结肿大", "肝肿大", "脾肿大", "腹部包块",
    # common signs & history phrases
    "既往史", "过敏史", "家族史", "手术史", "外伤史", "输血史",
    "伴随症状", "阵发性", "持续性", "间歇性", "进行性加重",
    "急性发作", "慢性病程", "前期", "输液", "急性", "油腻",
    "头疼", "颜面部痛",
]
