"""Polyphone disambiguation + erhua data for the TTS text frontend.

Copy of `toolbox_for_asr_and_tts_tpu/tts/polyphones.py` for the port
(framework-free; imports kept relative).

Rule data replacing the corresponding part of the reference's native
`ttsfrd` frontend (tts-service/Dockerfile:61-64; survey §7 hard part:
"TTS text frontend"). WORD_PINYIN holds the top polyphonic characters in
their disambiguating compounds (word → tone-numbered pinyin, space
separated); the G2P segments text greedy-longest-match against it before
falling back to per-character readings. ERHUA_WORDS lists the lexicalized
儿化 words whose trailing 儿 rhotacizes the previous final instead of being
its own syllable.
"""

# word → pinyin (space-separated, tone-numbered). Covers the common
# polyphones 行/重/长/得/乐/觉/教/血/数/便/调/发/还/着/了/背/结/切/率/当/
# 只/种/好/空/干/传/应/差/答/晕/处/系/转/累/咽/看/正/分/量/相/更/几/假/
# 恶/塞/卡/给/难/降/脏/地 in their frequent compounds, with extra weight on
# the medical domain the reference serves.
WORD_PINYIN = {
    # 行 xing2 / hang2
    "银行": "yin2 hang2", "行业": "hang2 ye4", "一行": "yi4 hang2",
    "行走": "xing2 zou3", "进行": "jin4 xing2", "行为": "xing2 wei2",
    "不行": "bu4 xing2", "运行": "yun4 xing2", "执行": "zhi2 xing2",
    # 重 zhong4 / chong2
    "重要": "zhong4 yao4", "体重": "ti3 zhong4", "严重": "yan2 zhong4",
    "重量": "zhong4 liang4", "重度": "zhong4 du4",
    "重复": "chong2 fu4", "重新": "chong2 xin1", "重来": "chong2 lai2",
    "重建": "chong2 jian4",
    # 长 chang2 / zhang3
    "长期": "chang2 qi1", "长度": "chang2 du4", "延长": "yan2 chang2",
    "长时间": "chang2 shi2 jian1",
    "长大": "zhang3 da4", "成长": "cheng2 zhang3", "增长": "zeng1 zhang3",
    "院长": "yuan4 zhang3", "生长": "sheng1 zhang3", "家长": "jia1 zhang3",
    # 得 de2 / dei3 / de5
    "得到": "de2 dao4", "获得": "huo4 de2", "得分": "de2 fen1",
    "取得": "qu3 de2", "觉得": "jue2 de5", "记得": "ji4 de5",
    "显得": "xian3 de5", "值得": "zhi2 de5",
    # 乐 le4 / yue4
    "快乐": "kuai4 le4", "乐观": "le4 guan1", "音乐": "yin1 yue4",
    "乐器": "yue4 qi4",
    # 觉 jue2 / jiao4
    "感觉": "gan3 jue2", "睡觉": "shui4 jiao4", "午觉": "wu3 jiao4",
    "一觉": "yi2 jiao4",
    # 教 jiao4 / jiao1
    "教育": "jiao4 yu4", "教室": "jiao4 shi4", "请教": "qing3 jiao4",
    "教书": "jiao1 shu1", "教给": "jiao1 gei3",
    # 血 xue4 / xie3
    "血压": "xue4 ya1", "血糖": "xue4 tang2", "血脂": "xue4 zhi1",
    "血液": "xue4 ye4", "贫血": "pin2 xue4", "血管": "xue4 guan3",
    "血常规": "xue4 chang2 gui1", "流血": "liu2 xie3",
    # 数 shu4 / shu3
    "数字": "shu4 zi4", "数量": "shu4 liang4", "次数": "ci4 shu4",
    "数值": "shu4 zhi2", "指数": "zhi3 shu4", "数一数": "shu3 yi5 shu3",
    # 便 bian4 / pian2
    "方便": "fang1 bian4", "大便": "da4 bian4", "小便": "xiao3 bian4",
    "便秘": "bian4 mi4", "便宜": "pian2 yi5",
    # 调 tiao2 / diao4
    "调整": "tiao2 zheng3", "调节": "tiao2 jie2", "调理": "tiao2 li3",
    "调查": "diao4 cha2", "音调": "yin1 diao4",
    # 发 fa1 / fa4
    "发现": "fa1 xian4", "发烧": "fa1 shao1", "发炎": "fa1 yan2",
    "复发": "fu4 fa1", "头发": "tou2 fa4", "理发": "li3 fa4",
    "白发": "bai2 fa4", "毛发": "mao2 fa4", "脱发": "tuo1 fa4",
    # 还 hai2 / huan2
    "还有": "hai2 you3", "还是": "hai2 shi4", "还要": "hai2 yao4",
    "归还": "gui1 huan2", "还款": "huan2 kuan3",
    # 着 zhe5 / zhao2 / zhuo2
    "着急": "zhao2 ji2", "着凉": "zhao2 liang2", "睡着": "shui4 zhao2",
    # (穿着 moved to a context rule in postagger.py round 5: the noun
    # reading chuan1 zhuo2 only holds before a predicate/clause edge;
    # 穿着+object is the durative 穿 zhe5)
    "附着": "fu4 zhuo2",
    # 了 le5 / liao3
    "了解": "liao3 jie3", "了不起": "liao3 bu5 qi3",
    # 背 bei4 / bei1
    "背部": "bei4 bu4", "后背": "hou4 bei4", "背包": "bei1 bao1",
    # 结 jie2 / jie1
    "结果": "jie2 guo3", "结石": "jie2 shi2", "结论": "jie2 lun4",
    "结实": "jie1 shi5",
    # 切 qie4 / qie1
    "一切": "yi2 qie4", "密切": "mi4 qie4", "切除": "qie1 chu2",
    "切开": "qie1 kai1",
    # 率 lv4 / shuai4
    "心率": "xin1 lv4", "概率": "gai4 lv4", "效率": "xiao4 lv4",
    "率领": "shuai4 ling3",
    # 当 dang1 / dang4
    "当时": "dang1 shi2", "应当": "ying1 dang1", "上当": "shang4 dang4",
    "当作": "dang4 zuo4",
    # 只 zhi3 / zhi1
    "只有": "zhi3 you3", "只是": "zhi3 shi4", "一只": "yi4 zhi1",
    # 种 zhong3 / zhong4
    "种类": "zhong3 lei4", "一种": "yi4 zhong3", "种植": "zhong4 zhi2",
    "接种": "jie1 zhong4",
    # 好 hao3 / hao4
    "爱好": "ai4 hao4", "好奇": "hao4 qi2",
    # 空 kong1 / kong4
    "空气": "kong1 qi4", "天空": "tian1 kong1", "空腹": "kong1 fu4",
    "空闲": "kong4 xian2", "有空": "you3 kong4",
    # 干 gan1 / gan4
    "干燥": "gan1 zao4", "干净": "gan1 jing4", "饼干": "bing3 gan1",
    "干活": "gan4 huo2", "能干": "neng2 gan4",
    # 传 chuan2 / zhuan4
    "传染": "chuan2 ran3", "遗传": "yi2 chuan2", "宣传": "xuan1 chuan2",
    "传记": "zhuan4 ji4",
    # 应 ying1 / ying4
    "应该": "ying1 gai1", "反应": "fan3 ying4", "应用": "ying4 yong4",
    "适应": "shi4 ying4",
    # 差 cha4 / cha1 / chai1
    "差不多": "cha4 bu5 duo1", "很差": "hen3 cha4", "差异": "cha1 yi4",
    "误差": "wu4 cha1", "出差": "chu1 chai1",
    # 答 da2 / da1
    "回答": "hui2 da2", "答案": "da2 an4", "答应": "da1 ying5",
    # 晕 yun1 / yun4
    "头晕": "tou2 yun1", "晕倒": "yun1 dao3", "晕车": "yun4 che1",
    # 处 chu4 / chu3
    "好处": "hao3 chu4", "到处": "dao4 chu4", "处理": "chu3 li3",
    "处方": "chu3 fang1", "处于": "chu3 yu2",
    # 系 xi4 / ji4
    "关系": "guan1 xi4", "系统": "xi4 tong3", "系鞋带": "ji4 xie2 dai4",
    # 转 zhuan3 / zhuan4
    "转变": "zhuan3 bian4", "好转": "hao3 zhuan3", "转诊": "zhuan3 zhen3",
    "转圈": "zhuan4 quan1",
    # 累 lei4 / lei3
    "劳累": "lao2 lei4", "很累": "hen3 lei4", "积累": "ji1 lei3",
    # 咽 yan1 / yan4
    "咽喉": "yan1 hou2", "咽部": "yan1 bu4", "吞咽": "tun1 yan4",
    # 看 kan4 / kan1
    "看病": "kan4 bing4", "看护": "kan1 hu4",
    # 正 zheng4 / zheng1
    "正常": "zheng4 chang2", "正月": "zheng1 yue4",
    # 分 fen1 / fen4
    "分析": "fen1 xi1", "分钟": "fen1 zhong1", "部分": "bu4 fen4",
    "分量": "fen4 liang4", "充分": "chong1 fen4",
    # 量 liang4 / liang2
    "质量": "zhi4 liang4", "剂量": "ji4 liang4", "用量": "yong4 liang4",
    "测量": "ce4 liang2", "量血压": "liang2 xue4 ya1",
    # 相 xiang1 / xiang4
    "相关": "xiang1 guan1", "互相": "hu4 xiang1", "照相": "zhao4 xiang4",
    "相片": "xiang4 pian4",
    # 更 geng4 / geng1
    "更加": "geng4 jia1", "更好": "geng4 hao3", "更换": "geng1 huan4",
    "更新": "geng1 xin1",
    # 几 ji3 / ji1
    "几个": "ji3 ge4", "几乎": "ji1 hu1",
    # 假 jia3 / jia4
    "假设": "jia3 she4", "假性": "jia3 xing4", "放假": "fang4 jia4",
    "假期": "jia4 qi1",
    # 恶 e4 / e3 / wu4
    "恶化": "e4 hua4", "恶性": "e4 xing4", "恶心": "e3 xin1",
    "厌恶": "yan4 wu4",
    # 塞 sai1 / se4
    "栓塞": "shuan1 se4", "梗塞": "geng3 se4", "塞住": "sai1 zhu4",
    # 卡 ka3 / qia3
    "卡片": "ka3 pian4", "卡住": "qia3 zhu4",
    # 给 gei3 / ji3
    "给予": "ji3 yu3",
    # 难 nan2 / nan4
    "困难": "kun4 nan5", "难受": "nan2 shou4", "灾难": "zai1 nan4",
    "难民": "nan4 min2",
    # 降 jiang4 / xiang2
    "下降": "xia4 jiang4", "降低": "jiang4 di1", "降压": "jiang4 ya1",
    "投降": "tou2 xiang2",
    # 脏 zang4 / zang1
    "心脏": "xin1 zang4", "肾脏": "shen4 zang4", "肝脏": "gan1 zang4",
    "内脏": "nei4 zang4", "很脏": "hen3 zang1",
    # 地 di4 / de5 (adverbial 地 needs POS; lexicalize the frequent ones)
    "地方": "di4 fang1", "地点": "di4 dian3", "慢慢地": "man4 man4 de5",
    "好好地": "hao3 hao3 de5",
    # 供 gong1 / gong4
    "提供": "ti2 gong1", "供奉": "gong4 feng4",
    # 缝 feng2 / feng4
    "缝合": "feng2 he2", "裂缝": "lie4 feng4",
    # 弹 tan2 / dan4
    "弹性": "tan2 xing4", "子弹": "zi3 dan4",
    # 薄 bo2 / bao2
    "薄弱": "bo2 ruo4", "很薄": "hen3 bao2",
    # 中 zhong1 / zhong4 (medical: 中风/中暑/中毒)
    "中风": "zhong4 feng1", "中暑": "zhong4 shu3", "中毒": "zhong4 du2",
    "击中": "ji1 zhong4", "中奖": "zhong4 jiang3",
    # 吐 tu3 / tu4
    "呕吐": "ou3 tu4", "吐血": "tu4 xie3", "吐出": "tu3 chu1",
    # 散 san4 / san3
    "散步": "san4 bu4", "松散": "song1 san3", "散剂": "san3 ji4",
    "扩散": "kuo4 san4",
    # 倒 dao3 / dao4
    "摔倒": "shuai1 dao3", "跌倒": "die1 dao3", "倒水": "dao4 shui3",
    "倒是": "dao4 shi4", "倒立": "dao4 li4",
    # 扎 zha1 / za1
    "扎针": "zha1 zhen1", "结扎": "jie2 za1", "包扎": "bao1 za1",
    # 创 chuang1 / chuang4
    "创伤": "chuang1 shang1", "创口": "chuang1 kou3",
    "创可贴": "chuang1 ke3 tie1", "创造": "chuang4 zao4",
    "创新": "chuang4 xin1",
    # 咽 third reading ye4
    "哽咽": "geng3 ye4",
    # 调剂 (pharmacy) tiao2
    "调剂": "tiao2 ji4",
    # 量体温 liang2
    "量体温": "liang2 ti3 wen1",
    # 脉 mai4 (号脉/脉搏 keep default); 提防 di1
    "脉搏": "mai4 bo2", "提防": "di1 fang2",
    # 钥匙 shi5
    "钥匙": "yao4 shi5",
    # 数落 shu3
    "数落": "shu3 luo5",
    # ---- round-2b growth: new polyphone families (medical-weighted) ----
    # 为 wei2 / wei4
    "因为": "yin1 wei4", "为了": "wei4 le5", "认为": "ren4 wei2",
    "作为": "zuo4 wei2", "成为": "cheng2 wei2", "以为": "yi3 wei2",
    # 会 hui4 / kuai4
    "会计": "kuai4 ji4",
    # 和 he2 / huo5
    "暖和": "nuan3 huo5",
    # 落 luo4 / lao4 / la4
    "落枕": "lao4 zhen3", "降落": "jiang4 luo4", "落后": "luo4 hou4",
    "落下病根": "la4 xia4 bing4 gen1",
    # 露 lu4 / lou4
    "暴露": "bao4 lu4", "露出": "lou4 chu1", "露水": "lu4 shui3",
    # 削 xiao1 / xue1
    "削皮": "xiao1 pi2", "削弱": "xue1 ruo4", "剥削": "bo1 xue1",
    # 铺 pu1 / pu4
    "铺床": "pu1 chuang2", "床铺": "chuang2 pu4", "药铺": "yao4 pu4",
    # 挑 tiao1 / tiao3
    "挑选": "tiao1 xuan3", "挑战": "tiao3 zhan4",
    # 圈 quan1 / juan4
    "圆圈": "yuan2 quan1", "猪圈": "zhu1 juan4",
    # 壳 ke2 / qiao4
    "蛋壳": "dan4 ke2", "地壳": "di4 qiao4",
    # 吓 xia4 / he4
    "吓一跳": "xia4 yi2 tiao4", "恐吓": "kong3 he4",
    # 埋 mai2 / man2
    "埋伏": "mai2 fu2", "埋怨": "man2 yuan4",
    # 泊 bo2 / po1
    "停泊": "ting2 bo2", "湖泊": "hu2 po1",
    # 磨 mo2 / mo4
    "磨损": "mo2 sun3", "磨牙": "mo2 ya2", "折磨": "zhe2 mo2",
    "磨坊": "mo4 fang2",
    # 漂 piao1 / piao3 / piao4
    "漂浮": "piao1 fu2", "漂白": "piao3 bai2", "漂亮": "piao4 liang5",
    # 喷 pen1 / pen4
    "喷嚏": "pen1 ti4", "喷雾": "pen1 wu4", "喷香": "pen4 xiang1",
    # 屏 ping2 / bing3 (屏气/屏住呼吸: breath-hold instructions)
    "屏幕": "ping2 mu4", "屏住": "bing3 zhu4", "屏气": "bing3 qi4",
    # 曲 qu1 / qu3
    "弯曲": "wan1 qu1", "曲线": "qu1 xian4", "歌曲": "ge1 qu3",
    # 兴 xing1 / xing4
    "兴奋": "xing1 fen4", "高兴": "gao1 xing4", "兴趣": "xing4 qu4",
    # 宁 ning2 / ning4
    "安宁": "an1 ning2", "宁愿": "ning4 yuan4", "宁可": "ning4 ke3",
    # 症 zheng4 / zheng1
    "症状": "zheng4 zhuang4", "炎症": "yan2 zheng4", "症结": "zheng1 jie2",
    # 粘 zhan1 / nian2 (粘膜/粘稠: sputum descriptions)
    "粘膜": "nian2 mo2", "粘稠": "nian2 chou2", "粘贴": "zhan1 tie1",
    "粘连": "zhan1 lian2",
    # 冠 guan1 / guan4 (冠心病/冠状动脉)
    "冠心病": "guan1 xin1 bing4", "冠状": "guan1 zhuang4",
    "冠军": "guan4 jun1",
    # 龟 gui1 / jun1
    "乌龟": "wu1 gui1", "龟裂": "jun1 lie4",
    # 嚼 jiao2 / jue2
    "咀嚼": "ju3 jue2", "嚼碎": "jiao2 sui4",
    # 校 xiao4 / jiao4 (校准: device calibration)
    "学校": "xue2 xiao4", "校对": "jiao4 dui4", "校准": "jiao4 zhun3",
    # 禁 jin4 / jin1 (禁食/禁忌: pre-op instructions)
    "禁忌": "jin4 ji4", "禁食": "jin4 shi2", "不禁": "bu4 jin1",
    # 卷 juan3 / juan4 (问卷: intake questionnaires)
    "卷起": "juan3 qi3", "试卷": "shi4 juan4", "问卷": "wen4 juan4",
    # 抹 mo3 / ma1 (涂抹药膏)
    "涂抹": "tu2 mo3", "抹布": "ma1 bu4",
    # 强 qiang2 / qiang3 / jiang4 (强迫症)
    "增强": "zeng1 qiang2", "勉强": "mian3 qiang3",
    "强迫": "qiang3 po4", "倔强": "jue2 jiang4",
    # 盛 sheng4 / cheng2
    "旺盛": "wang4 sheng4", "盛饭": "cheng2 fan4",
    # 似 si4 / shi4
    "类似": "lei4 si4", "似的": "shi4 de5",
    # 的 de5 / di4 / di2 / di1 (default is the particle de5)
    "目的地": "mu4 di4 di4", "目的": "mu4 di4", "的确": "di2 que4",
    "的士": "di1 shi4", "打的": "da3 di1", "有的放矢": "you3 di4 fang4 shi3",
    # round-2d POS-dependent tail: readings ttsfrd resolves with a POS
    # tagger, closed here as high-frequency lexical units
    "长得": "zhang3 de5", "还给": "huan2 gei3", "将军": "jiang1 jun1",
    "数数": "shu3 shu4", "数了数": "shu3 le5 shu3",
    "着手": "zhuo2 shou3", "着想": "zhuo2 xiang3",
    "种地": "zhong4 di4", "耕种": "geng1 zhong4", "空调": "kong1 tiao2",
    "相处": "xiang1 chu3", "骨干": "gu3 gan4", "计划": "ji4 hua4",
    "薄荷": "bo4 he5", "单薄": "dan1 bo2", "朝阳": "chao2 yang2",
    "孩子": "hai2 zi5", "眼睛": "yan3 jing1", "弹钢琴": "tan2 gang1 qin2",
    "咯血": "ka3 xie3",
    "朝代": "chao2 dai4", "首都": "shou3 du1", "为了": "wei4 le5",
    "作为": "zuo4 wei2", "成为": "cheng2 wei2", "行为": "xing2 wei2",
    "以为": "yi3 wei2", "为主": "wei2 zhu3", "为期": "wei2 qi1",
    "难民": "nan4 min2", "灾难": "zai1 nan4", "磨难": "mo2 nan4",
    "困难": "kun4 nan5", "曲子": "qu3 zi5", "歌曲": "ge1 qu3",
    "戏曲": "xi4 qu3", "弹性": "tan2 xing4", "弹琴": "tan2 qin2",
    "反弹": "fan3 tan2", "露面": "lou4 mian4", "露馅": "lou4 xian4",
    "占卜": "zhan1 bu3",
    # 涨 zhang3 / zhang4 (头昏脑涨)
    "涨价": "zhang3 jia4", "脑涨": "nao3 zhang4", "涨红": "zhang4 hong2",
    # 折 zhe2 / zhe1 / she2 (骨折 is default zhe2)
    "骨折": "gu3 zhe2", "折腾": "zhe1 teng5", "折本": "she2 ben3",
    # 占 zhan4 / zhan1
    "占卜": "zhan1 bu3",
    # 藏 cang2 / zang4
    "隐藏": "yin3 cang2", "西藏": "xi1 zang4",
    # 朝 chao2 / zhao1
    "朝向": "chao2 xiang4", "朝气": "zhao1 qi4",
    # 都 dou1 / du1
    "首都": "shou3 du1",
    # 曾 ceng2
    "曾经": "ceng2 jing1",
    # 荨麻疹 xun2 (hives)
    "荨麻疹": "xun2 ma2 zhen3",
    # 疟疾 nve4 (malaria)
    "疟疾": "nve4 ji2",
    # 佝偻病 gou1 lou2 (rickets)
    "佝偻": "gou1 lou2",
    # 脑卒中 cu4 (stroke, the clinical term)
    "脑卒中": "nao3 cu4 zhong4", "卒中": "cu4 zhong4",
    # 模 mo2 / mu2
    "模型": "mo2 xing2", "模样": "mu2 yang4",
    # 哄 hong3 / hong4
    "哄骗": "hong3 pian4", "起哄": "qi3 hong4",
    # 横 heng2 / heng4
    "横向": "heng2 xiang4", "蛮横": "man2 heng4",
    # 喝 he1 / he4
    "喝彩": "he4 cai3",
    # 茄 qie2 / jia1
    "茄子": "qie2 zi5", "雪茄": "xue3 jia1",
    # 浆 jiang1 (血浆: plasma)
    "血浆": "xue4 jiang1", "豆浆": "dou4 jiang1",
    # 撒 sa1 / sa3
    "撒尿": "sa1 niao4", "播撒": "bo1 sa3",
    # 丧 sang4 / sang1 (丧失意识)
    "丧失": "sang4 shi1", "沮丧": "ju3 sang4", "丧事": "sang1 shi4",
    # 扫 sao3 / sao4 (扫描: CT/MRI)
    "扫描": "sao3 miao2", "扫帚": "sao4 zhou5",
    # 舍 she3 / she4
    "舍得": "she3 de5", "宿舍": "su4 she4",
    # 尽 jin3 / jin4 (尽量/尽快: dosage instructions)
    "尽量": "jin3 liang4", "尽快": "jin3 kuai4", "用尽": "yong4 jin4",
    # 奇 qi2 / ji1
    "奇数": "ji1 shu4",
    # 轧 ya4 (轧伤: crush injury)
    "轧伤": "ya4 shang1",
    # 载 zai4 / zai3
    "记载": "ji4 zai3", "超载": "chao1 zai4",
    # 佛 fo2 / fu2
    "仿佛": "fang3 fu2",
    # 翘 qiao2 (连翘: TCM herb)
    "连翘": "lian2 qiao2", "翘起": "qiao4 qi3",
    # 稍 shao1 / shao4
    "稍等": "shao1 deng3", "稍息": "shao4 xi1",
    # 悄 qiao1 / qiao3
    "悄悄": "qiao1 qiao1", "悄然": "qiao3 ran2",
    # 匙 chi2 (汤匙: dosage spoon)
    "汤匙": "tang1 chi2",
    # 肚 du4 / du3
    "肚子": "du4 zi5", "猪肚": "zhu1 du3",
    # 夹 jia1 / jia2 (主动脉夹层)
    "夹层": "jia1 ceng2", "夹袄": "jia2 ao3",
    # 亲 qin1 / qing4
    "亲属": "qin1 shu3", "亲家": "qing4 jia5",
    # 参 can1 / shen1 (TCM)
    "人参": "ren2 shen1", "参差": "cen1 ci1",
    # 地 di4 compounds LOCKED so the adverbial-de5 context rule can't touch
    # them (场地打扫 must stay di4 even before a verb)
    "土地": "tu3 di4", "场地": "chang3 di4", "基地": "ji1 di4",
    "当地": "dang1 di4", "本地": "ben3 di4", "各地": "ge4 di4",
    "内地": "nei4 di4", "外地": "wai4 di4", "工地": "gong1 di4",
    "大地": "da4 di4", "地上": "di4 shang4", "地下": "di4 xia4",
    "地面": "di4 mian4", "地区": "di4 qu1", "地址": "di4 zhi3",
    "地铁": "di4 tie3", "地图": "di4 tu2", "地板": "di4 ban3",
    "地位": "di4 wei4", "地球": "di4 qiu2",
    # 得了 as "contracted (an illness)" stays de2 le5
    "得了感冒": "de2 le5 gan3 mao4", "得病": "de2 bing4",
}

# round-3 eval-extension closures (docs/G2P.md): compounds the blind
# held-out sentences exposed as missing
WORD_PINYIN.update({
    "拉磨": "la1 mo4", "石磨": "shi2 mo4", "磨坊": "mo4 fang2",
    "留空": "liu2 kong4", "填空": "tian2 kong4",
    "水浒传": "shui3 hu3 zhuan4", "自传": "zi4 zhuan4",
    "列传": "lie4 zhuan4", "传记": "zhuan4 ji4",
    "量身高": "liang2 shen1 gao1",
    "请假": "qing3 jia4", "放假": "fang4 jia4", "休假": "xiu1 jia4",
    "假期": "jia4 qi1", "病假": "bing4 jia4", "产假": "chan3 jia4",
})

# round-3b blind-extension closures (docs/G2P.md): the 48-sentence second
# blind set (24 new chars) missed 9; these are the compound closures, the
# productive shapes go to postagger round-3b rules
WORD_PINYIN.update({
    # 塞 se4 in bound literary compounds (sai1 stays the free default)
    "堵塞": "du3 se4", "阻塞": "zu3 se4", "闭塞": "bi4 se4",
    # 角 jue2 (role): the theatrical family
    "主角": "zhu3 jue2", "配角": "pei4 jue2", "角色": "jue2 se4",
    "角逐": "jue2 zhu2",
    # 给 ji3 (supply register)
    "补给": "bu3 ji3", "供给": "gong1 ji3", "给养": "ji3 yang3",
    # 脏 zang4 organs beyond the round-2 set
    "脾脏": "pi2 zang4", "胰脏": "yi2 zang4", "脏器": "zang4 qi4",
    "五脏": "wu3 zang4",
    # 散 san3 (loose/powder nominal family)
    "散文": "san3 wen2", "散装": "san3 zhuang1", "懒散": "lan3 san3",
    "零散": "ling2 san3",
    # 缝 feng4 (crack nominal family; feng2 verb stays default)
    "门缝": "men2 feng4", "缝隙": "feng4 xi4", "夹缝": "jia1 feng4",
    "接缝": "jie1 feng4", "缝纫": "feng2 ren4",
    # 铺 pu4 (shop/bunk nominal family; pu1 verb stays default)
    "店铺": "dian4 pu4", "铺位": "pu4 wei4", "当铺": "dang4 pu4",
    "卧铺": "wo4 pu4", "铺子": "pu4 zi5",
    # 卷 juan4 (document nominal family; juan3 verb stays default)
    "考卷": "kao3 juan4", "试题卷": "shi4 ti2 juan4",
    "答卷": "da2 juan4", "画卷": "hua4 juan4", "胶卷": "jiao1 juan3",
})

# round-3c blind-extension closures (docs/G2P.md): the 57-sentence third
# blind set (30 chars) — compound closures for the wrong-reading misses and
# the alternate readings of the 11 newly-tabled chars
WORD_PINYIN.update({
    # 担 dan4 (burden nominal; dan1 verb stays default)
    "重担": "zhong4 dan4", "担子": "dan4 zi5", "扁担": "bian3 dan5",
    # 划 hua2 (paddle/scratch verb family; hua4 plan stays default)
    "划船": "hua2 chuan2", "划桨": "hua2 jiang3", "划算": "hua2 suan4",
    "划伤": "hua2 shang1",
    # 撒 sa1 (let-go verb family; sa3 scatter stays default)
    "撒开": "sa1 kai1", "撒手": "sa1 shou3", "撒谎": "sa1 huang3",
    "撒娇": "sa1 jiao1", "撒尿了": "sa1 niao4 le5",
    # 钻 zuan4 (tool/gem nominal; zuan1 verb is the table default)
    "电钻": "dian4 zuan4", "钻头": "zuan4 tou2", "钻石": "zuan4 shi2",
    "钻戒": "zuan4 jie4",
    # 巷 hang4 (mining register)
    "巷道": "hang4 dao4",
    # 刹 cha4 (instant register; sha1 brake is the table default)
    "刹那": "cha4 na4", "一刹": "yi2 cha4",
    # 杆 gan3 (stalk/rod diminutive + MEDICAL 杆菌; gan1 pole default)
    "杆菌": "gan3 jun1", "枪杆": "qiang1 gan3", "笔杆": "bi3 gan3",
    "秤杆": "cheng4 gan3", "杆秤": "gan3 cheng4",
    # 挨 ai2 (suffer; ai1 next-to is the table default)
    "挨打": "ai2 da3", "挨骂": "ai2 ma4", "挨饿": "ai2 e4",
    "挨批": "ai2 pi1",
    # 奔 ben4 (toward; ben1 run is the table default)
    "投奔": "tou2 ben4", "奔头": "ben4 tou5", "直奔": "zhi2 ben4",
    # 拧 ning3 (rotate; ning2 wring is the table default)
    "拧紧": "ning3 jin3", "拧开": "ning3 kai1", "拧松": "ning3 song1",
    # 伺 ci4 (serve; si4 watch-for is the table default)
    "伺候": "ci4 hou5",
    # 晃 huang3 (dazzle; huang4 sway is the table default)
    "明晃晃": "ming2 huang3 huang3", "晃眼": "huang3 yan3",
    # 逮 dai4 (formal arrest; dai3 catch is the table default)
    "逮捕": "dai4 bu3",
    # 撇 pie3 (mouth/stroke; pie1 skim/cast-aside is the table default)
    "撇嘴": "pie3 zui3", "撇着嘴": "pie3 zhe5 zui3",
    # 吐 tu3 (speak/spit deliberately; tu4 vomit senses)
    "吐字": "tu3 zi4", "吐痰": "tu3 tan2", "谈吐": "tan2 tu3",
    "吞吐": "tun1 tu3", "吐露": "tu3 lu4",
    # 脉 mo4 (reduplicated gaze register)
    "脉脉": "mo4 mo4",
})

# round-3d coverage-batch polyphones: alternate readings for chars whose
# table default was added by the round-3d sweep (pinyin_data.py)
WORD_PINYIN.update({
    # 炸 zha2 (cooking register; zha4 explode is the table default)
    "油炸": "you2 zha2", "炸鸡": "zha2 ji1", "炸酱": "zha2 jiang4",
    "炸糕": "zha2 gao1", "炸油条": "zha2 you2 tiao2", "炸丸子": "zha2 wan2 zi5",
    # 磅 pang2 (磅礴; bang4 weight is the table default)
    "磅礴": "pang2 bo2",
    # 扇 shan1 (verb fan/slap; shan4 noun is the table default)
    "扇风": "shan1 feng1", "扇了": "shan1 le5", "扇动": "shan1 dong4",
    # 笼 long3 (cover register; long2 cage is the table default)
    "笼罩": "long3 zhao4", "笼统": "long3 tong3",
    # 柏 bo2 (transliteration register; bai3 tree is the table default)
    "柏林": "bo2 lin2",
    # 燕 yan1 (place-name register; yan4 bird is the table default)
    "燕京": "yan1 jing1", "燕山": "yan1 shan1",
})


# lexicalized 儿化 words: the trailing 儿 rhotacizes the previous final
ERHUA_WORDS = {
    "这儿", "那儿", "哪儿", "一点儿", "有点儿", "一会儿", "等会儿",
    "玩儿", "味儿", "劲儿", "事儿", "花儿", "鸟儿", "个儿", "份儿",
    "头儿", "门儿", "面儿", "边儿", "小孩儿", "大伙儿", "没事儿",
}

# Round-3e coverage-batch polyphones: alternate readings for chars whose
# table default was added (or corrected) by the round-3e collation sweep.
WORD_PINYIN.update({
    # 膀 bang3 is now the table default (肩膀/翅膀); 膀胱 keeps pang2
    "膀胱": "pang2 guang1",
    # 斗 dou4 (fight register is the table default); measure/ladle nouns dou3
    "北斗": "bei3 dou3", "烟斗": "yan1 dou3", "漏斗": "lou4 dou3",
    "筋斗": "jin1 dou3",
    # 勒 le4 (compel/Le- transliteration default); lei1 tighten register
    "勒紧": "lei1 jin3",
    # 畜 chu4 (牲畜 noun default); xu4 verb/husbandry register
    "畜牧": "xu4 mu4", "畜养": "xu4 yang3",
    # 纤 xian1 (纤维 default); qian4 tow-rope register
    "纤夫": "qian4 fu1", "拉纤": "la1 qian4",
    # 辟 pi4 (开辟 default); bi4 monarch register
    "复辟": "fu4 bi4",
    # 殷 yin1 (殷勤/殷商 default); yan1 dark-red register
    "殷红": "yan1 hong2",
    # 番 fan1 default; 番禺 place name pan1
    "番禺": "pan1 yu2",
    # 俩 lia3 default; 伎俩 reads liang3
    "伎俩": "ji4 liang3",
    # 甚 shen4 (甚至 default); interrogative register shen2
    "甚么": "shen2 me5",
    # 著 zhu4 (著名/著作 default); zhuo2 in 执著 (variant of 执着)
    "执著": "zhi2 zhuo2",
    # 蒙 meng2 default; meng3 ethnonym, meng1 deceive register
    "蒙古": "meng3 gu3", "蒙骗": "meng1 pian4",
    # 踏 ta4 default; 踏实 reads ta1
    "踏实": "ta1 shi5",
    # 轴 zhou2 default; 压轴 reads zhou4
    "压轴": "ya1 zhou4",
    # 炮 pao4 (artillery default); pao2 process-herbs register
    "炮制": "pao2 zhi4",
})

# Round-3f coverage-batch polyphones: alternate readings for chars whose
# table default was added by the round-3f top-2500 sweep.
WORD_PINYIN.update({
    # 厦 sha4 (大厦 default); 厦门 place name xia4
    "厦门": "xia4 men2",
    # 拓 tuo4 (开拓/拓展 default); ta4 rubbing register
    "拓片": "ta4 pian4", "拓本": "ta4 ben3",
    # 帖 tie3 (帖子/请帖 default); tie1 settled, tie4 calligraphy-model
    "妥帖": "tuo3 tie1", "服帖": "fu2 tie1",
    "字帖": "zi4 tie4", "碑帖": "bei1 tie4", "画帖": "hua4 tie4",
    # 仆 pu2 (仆人 default); pu1 fall-forward register
    "前仆后继": "qian2 pu1 hou4 ji4", "仆倒": "pu1 dao3",
    # 佣 yong1 (佣人 default); yong4 commission
    "佣金": "yong4 jin1",
    # 葛 ge2 (plant/藤葛 default); ge3 surname register
    "诸葛": "zhu1 ge3",
    # 爪 zhao3 (鹰爪/爪牙 default); zhua3 colloquial register
    "爪子": "zhua3 zi5", "鸡爪": "ji1 zhua3", "爪尖": "zhua3 jian1",
    # 禅 chan2 (禅宗 default); shan4 abdication register
    "禅让": "shan4 rang4", "封禅": "feng1 shan4",
    # 怔 zheng1 (怔忪 default); zheng4 colloquial daze register
    "发怔": "fa1 zheng4", "怔住": "zheng4 zhu4",
})

# Round-3g coverage-batch polyphones: alternate readings for chars whose
# table default was added by the round-3g top-3000 sweep.
WORD_PINYIN.update({
    # 吁 xu1 (长吁短叹 default); yu4 appeal register
    "呼吁": "hu1 yu4",
    # 哗 hua1 (哗啦 onomatopoeia default); hua2 clamor register
    "喧哗": "xuan1 hua2", "哗然": "hua2 ran2",
    # 扒 ba1 (扒开 default); pa2 pickpocket/rake register
    "扒手": "pa2 shou3",
    # 拚 pan4 (舍弃 default); pin1 as variant of 拼 in 拚命
    "拚命": "pin1 ming4",
    # 陂 bei1 (陂塘 default); 黄陂 place name pi2
    "黄陂": "huang2 pi2",
    # 伽 jia1 (瑜伽 default); ga1 gamma transliteration, qie2 伽蓝
    "伽马": "ga1 ma3", "伽蓝": "qie2 lan2",
})

# Zhuyin cross-collation audit (round 3g): group-coherence check of the
# whole table against Unicode::Collate::CJK::Zhuyin surfaced two stale
# defaults (粘 nian2→zhan1 — normative verb reading, the adjective is 黏;
# 匙 shi5→chi2 — bare 匙 is chi2, 钥匙 shi5 stays lexical) and two
# missing onomatopoeia registers for 咯 (table default ka3 is the
# medical 咯血 register).
WORD_PINYIN.update({
    "琢磨": "zuo2 mo5",
    "咯噔": "ge1 deng1", "咯咯": "ge1 ge1",
})

# Round-3h blind-eval closures (docs/G2P.md): compound misses from the
# first-contact evaluation of the round-3e/3f/3g batches.
WORD_PINYIN.update({
    "扒窃": "pa2 qie4",
    "怔怔": "zheng4 zheng4",
    "拓印": "ta4 yin4",
    "墙缝": "qiang2 feng4",
})

# Round-3i coverage-batch polyphones.
WORD_PINYIN.update({
    # 苔 tai2 (苔藓 default); 舌苔 medical register tai1
    "舌苔": "she2 tai1",
    # 蚌 bang4 (clam default); 蚌埠 place name beng4
    "蚌埠": "beng4 bu4",
    # 耙 ba4 (耙地 verb default); pa2 rake-tool register
    "耙子": "pa2 zi5", "钉耙": "ding1 pa2",
})

# Round-4 external-set closures (docs/G2P.md; VERDICT-r3 #5): fixed
# expressions and dictionary words surfaced by the externally-authored
# evaluation set (tests/data/polyphone_eval_external.tsv) — chengyu carry
# lexicalized readings a ttsfrd-grade frontend ships as dictionary
# content. Classical-register items that are NOT fixed lexemes (朝如青丝,
# 还故乡, 同行十二年, 为异客) are deliberately NOT in this table — they
# need parsing, not lexicon, and are closed by frame rules in postagger.py
# (朝…暮 parallelism, copular 为 + clause-final NP, 还 + place NP,
# 同行 + duration).
WORD_PINYIN.update({
    # chengyu / fixed sayings (reading = 现代汉语词典 entry)
    "貌相": "mao4 xiang4", "斗量": "dou3 liang2",
    "万卷": "wan4 juan4",
    "拔苗助长": "ba2 miao2 zhu4 zhang3",
    "揠苗助长": "ya4 miao2 zhu4 zhang3",
    "丢三落四": "diu1 san1 la4 si4",
    "宁为玉碎": "ning4 wei2 yu4 sui4", "不为瓦全": "bu4 wei2 wa3 quan2",
    "量入为出": "liang4 ru4 wei2 chu1",
    "差之毫厘": "cha1 zhi1 hao2 li2",
    "一唱一和": "yi2 chang4 yi2 he4", "附和": "fu4 he4",
    "应和": "ying4 he4", "唱和": "chang4 he4",
    "阴差阳错": "yin1 cha1 yang2 cuo4",
    "曲高和寡": "qu3 gao1 he4 gua3",
    "心宽体胖": "xin1 kuan1 ti3 pan2",
    "否极泰来": "pi3 ji2 tai4 lai2",
    "供不应求": "gong1 bu2 ying4 qiu2",
    "排忧解难": "pai2 you1 jie3 nan4",
    "三年五载": "san1 nian2 wu3 zai3",
    "千载难逢": "qian1 zai3 nan2 feng2", "一年半载": "yi4 nian2 ban4 zai3",
    "重蹈覆辙": "chong2 dao3 fu4 zhe2",
    "鬼使神差": "gui3 shi3 shen2 chai1",
    "差强人意": "cha1 qiang2 ren2 yi4",
    "宁缺毋滥": "ning4 que1 wu2 lan4",
    "倒背如流": "dao4 bei4 ru2 liu2",
    "不了了之": "bu4 liao3 liao3 zhi1",
    "了如指掌": "liao3 ru2 zhi3 zhang3",
    "塞翁失马": "sai4 weng1 shi1 ma3",
    # classical fixed quotations (lexicalized as wholes in dictionaries)
    "不亦说乎": "bu2 yi4 yue4 hu1",
    "朝闻道": "zhao1 wen2 dao4",
    "数风流人物": "shu3 feng1 liu2 ren2 wu4",
    # dictionary words
    "可汗": "ke4 han2", "成吉思汗": "cheng2 ji2 si1 han2",
    "少小": "shao4 xiao3", "今朝": "jin1 zhao1",
})

# round-5 tranche-B closures (docs/G2P.md): every entry is a dictionary-
# attested reusable compound from the 19 first-contact misses of
# tests/data/polyphone_eval_external_b.tsv (statute / news / textbook /
# signage registers) — no per-sentence hacks.
WORD_PINYIN.update({
    # 应 ying4 (respond) compounds the medical-domain table lacked
    "供应": "gong1 ying4", "应急": "ying4 ji2", "响应": "xiang3 ying4",
    "应对": "ying4 dui4", "应聘": "ying4 pin4", "应邀": "ying4 yao1",
    "应战": "ying4 zhan4", "应诊": "ying4 zhen3",
    # 供 gong4 (confess/offer up) legal register
    "供认": "gong4 ren4", "供述": "gong4 shu4", "口供": "kou3 gong4",
    "供词": "gong4 ci2", "招供": "zhao1 gong4", "逼供": "bi1 gong4",
    "串供": "chuan4 gong4", "供品": "gong4 pin3",
    # 调 tiao2 (adjust) direction/result compounds (调查 diao4 stays)
    "下调": "xia4 tiao2", "上调": "shang4 tiao2", "调至": "tiao2 zhi4",
    "调低": "tiao2 di1", "调高": "tiao2 gao1", "微调": "wei1 tiao2",
    # 率 shuai4 (lead) — suffix 率 lv4 stays the default
    "率先": "shuai4 xian1", "率领": "shuai4 ling3", "统率": "tong3 shuai4",
    "率队": "shuai4 dui4", "表率": "biao3 shuai4",
    # 着 zhuo2 (touch down / apply) formal compounds
    "着陆": "zhuo2 lu4", "着重": "zhuo2 zhong4", "着力": "zhuo2 li4",
    "着想": "zhuo2 xiang3", "着装": "zhuo2 zhuang1",
    # 转 zhuan4 (revolve) vs zhuan3 (turn, default)
    "自转": "zi4 zhuan4", "公转": "gong1 zhuan4", "旋转": "xuan2 zhuan3",
    "转动": "zhuan4 dong4", "转速": "zhuan4 su4", "转盘": "zhuan4 pan2",
    # 间 jian4 (gap/interpose)
    "间隔": "jian4 ge2", "间断": "jian4 duan4", "间接": "jian4 jie1",
    "间歇": "jian4 xie1", "间谍": "jian4 die2", "离间": "li2 jian4",
    # 切 qie4 (imperative/earnest)
    "切勿": "qie4 wu4", "切记": "qie4 ji4", "切莫": "qie4 mo4",
    "切实": "qie4 shi2", "恳切": "ken3 qie4", "迫切": "po4 qie4",
    # 禁 jin1 (bear/withstand) — 禁止 jin4 stays the default
    "情不自禁": "qing2 bu2 zi4 jin1", "忍俊不禁": "ren3 jun4 bu4 jin1",
    "禁受": "jin1 shou4", "弱不禁风": "ruo4 bu4 jin1 feng1",
    # 系 ji4 (fasten) verb compounds — 系 xi4 (system/relation) default
    "系好": "ji4 hao3", "系上": "ji4 shang4", "系紧": "ji4 jin3",
    "系安全带": "ji4 an1 quan2 dai4",
    # 卡 qia3 (checkpoint/wedge)
    "关卡": "guan1 qia3", "卡壳": "qia3 ke2", "哨卡": "shao4 qia3",
    # 重 chong2 (again) additions
    "重启": "chong2 qi3", "重组": "chong2 zu3", "重返": "chong2 fan3",
    "重申": "chong2 shen1", "重播": "chong2 bo1", "重审": "chong2 shen3",
    # 模 mu2 (mold) — 模 mo2 (model) default
    "模具": "mu2 ju4", "模板": "mu2 ban3", "模子": "mu2 zi5",
    # 空 kong4 (vacant/spare time)
    "空地": "kong4 di4", "空隙": "kong4 xi4", "空闲": "kong4 xian2",
    "抽空": "chou1 kong4", "填空": "tian2 kong4",
    # 处 chu3 (handle/punish) verb compounds — 处 chu4 (place) default
    "判处": "pan4 chu3", "处罚": "chu3 fa2", "处以": "chu3 yi3",
    "处置": "chu3 zhi4", "惩处": "cheng2 chu3", "查处": "cha2 chu3",
    # chengyu
    "助人为乐": "zhu4 ren2 wei2 le4",
})

# round-5 tranche-C closures (docs/G2P.md): dictionary-attested reusable
# compounds from the 10 first-contact misses of
# tests/data/polyphone_eval_external_c.tsv (narrative prose / broadcast /
# recipe / sports / drug-label registers) — no per-sentence hacks.
WORD_PINYIN.update({
    # 少 shao4 (young) age words — 少 shao3 (few) stays the default
    "少年": "shao4 nian2", "少女": "shao4 nv3", "少儿": "shao4 er2",
    "青少年": "qing1 shao4 nian2", "少将": "shao4 jiang4",
    "男女老少": "nan2 nv3 lao3 shao4",
    # 处 chu5 neutral-tone nouns (现汉: 好处 hao3·chu)
    "好处": "hao3 chu5", "坏处": "huai4 chu5", "用处": "yong4 chu5",
    "长处": "chang2 chu5", "短处": "duan3 chu5",
    # 模 mu2 (mold) idioms — 模 mo2 (model) default
    "大模大样": "da4 mu2 da4 yang4",
    "装模作样": "zhuang1 mu2 zuo4 yang4",
    "一模一样": "yi4 mu2 yi2 yang4",
    # proper noun carrying both the shi2 and cha4 readings
    "什刹海": "shi2 cha4 hai3", "古刹": "gu3 cha4",
    # 调 tiao2 (mix/season) kitchen compounds — 调查 diao4 stays
    "调料": "tiao2 liao4", "调味": "tiao2 wei4", "调匀": "tiao2 yun2",
    "调和": "tiao2 he2", "烹调": "peng1 tiao2",
    # 和 huo2 (knead)
    "和面": "huo2 mian4", "和泥": "huo2 ni2",
    # clause-final copular 为 collocations (少说为佳 / 以早为宜)
    "为佳": "wei2 jia1", "为宜": "wei2 yi2", "为妙": "wei2 miao4",
    # common V过/X系/X少 words locked so the new frame rules above cannot
    # reach inside them (guards found by misfire probes, not the eval set)
    "通过": "tong1 guo4", "经过": "jing1 guo4", "路过": "lu4 guo4",
    "错过": "cuo4 guo4", "超过": "chao1 guo4", "穿过": "chuan1 guo4",
    "越过": "yue4 guo4", "绕过": "rao4 guo4", "透过": "tou4 guo4",
    "度过": "du4 guo4", "渡过": "du4 guo4", "跳过": "tiao4 guo4",
    "联系": "lian2 xi4", "体系": "ti3 xi4", "院系": "yuan4 xi4",
    "缺少": "que1 shao3", "减少": "jian3 shao3", "至少": "zhi4 shao3",
    "不少": "bu4 shao3", "多少": "duo1 shao3", "很少": "hen3 shao3",
})

# round-5 tranche-D closures (docs/G2P.md): dictionary-attested words
# from the 4 real first-contact misses of
# tests/data/polyphone_eval_external_d.tsv.
WORD_PINYIN.update({
    # lexical V+得 words read de5 (现汉: 觉得 jué·de, 变得 biàn·de …)
    "变得": "bian4 de5", "显得": "xian3 de5", "觉得": "jue2 de5",
    "记得": "ji4 de5", "懂得": "dong3 de5", "值得": "zhi2 de5",
    "晓得": "xiao3 de5", "免得": "mian3 de5", "省得": "sheng3 de5",
    # 倒 dao4 (pour) + 入, with dao3 fall-compounds locked as guards
    "倒入": "dao4 ru4", "摔倒": "shuai1 dao3", "跌倒": "die1 dao3",
    "倒下": "dao3 xia4",
})
